"""Distributed rendering: mesh-driven sessions, psum'd statistics, and a
real multi-process jax.distributed run (SURVEY §4 / §5.8).

The reference has no multi-node story at all (its "distributed system" is
std::thread over shared memory, /root/reference/camera.hpp:556-573); these
tests pin down the JAX build's replacement:
  * RenderSession(mesh=...) steps through parallel/render.sharded_accumulate
    and matches the single-device session bit-for-bit,
  * image statistics reduce with collectives (analyze_sharded == the
    host-side analyze_framebuffer),
  * a 2-process x 4-virtual-device jax.distributed render agrees with the
    single-process render (run in subprocesses so each owns its runtime).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_project_tpu.models import camera as cam_mod
from raytracer_project_tpu.models import environment as env_mod
from raytracer_project_tpu.models import presets
from raytracer_project_tpu.ops import integrator, post as post_mod
from raytracer_project_tpu.parallel import render as prender
from raytracer_project_tpu.utils.session import RenderSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(width=64, height=40, spp=4):
    scene = presets.shirley_final_scene(grid=3, with_bvh=True)
    cfg = integrator.RenderConfig(
        width=width, height=height, samples_per_pixel=spp, max_depth=5,
        env_mode=env_mod.PHYSICAL_SUN,
    )
    cam = cam_mod.make_camera(
        image_width=width, image_height=height, vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
    )
    env = env_mod.make_environment()
    return scene, cam, env, cfg


def test_session_mesh_matches_single_device():
    """A session stepping on the 8-device mesh produces bit-identical
    buffers to the unsharded session (lane RNG is pixel-keyed)."""
    scene, cam, env, cfg = _setup()
    mesh = prender.make_mesh(8)
    assert mesh.devices.size == 8

    s1 = RenderSession(scene, cam, env, cfg, chunk_samples=2)
    s8 = RenderSession(scene, cam, env, cfg, chunk_samples=2, mesh=mesh)
    s1.render_progressive(cfg.samples_per_pixel)
    s8.render_progressive(cfg.samples_per_pixel)
    b1 = s1.buffers()
    b8 = s8.buffers()
    for k in ("beauty", "albedo", "normal"):
        np.testing.assert_array_equal(np.asarray(b1[k]), np.asarray(b8[k]))


def test_session_mesh_statistics_psum():
    """Sharded statistics (collective reduction) match the host-side
    analyze_framebuffer on the gathered image."""
    scene, cam, env, cfg = _setup()
    mesh = prender.make_mesh(8)
    s8 = RenderSession(scene, cam, env, cfg, chunk_samples=4, mesh=mesh)
    s8.render_progressive(cfg.samples_per_pixel)

    sharded = s8.statistics()
    host = post_mod.analyze_framebuffer(s8.buffers()["beauty"])
    # Padding duplicates <= 7 rows of 2560 pixels; tolerances cover it.
    np.testing.assert_allclose(float(sharded.average_luminance),
                               float(host.average_luminance), rtol=2e-2)
    np.testing.assert_allclose(float(sharded.max_luminance),
                               float(host.max_luminance), rtol=1e-6)
    assert int(np.abs(np.asarray(sharded.histogram)
                      - np.asarray(host.histogram)).sum()) <= 2 * 7


def test_session_mesh_checkpoint_roundtrip(tmp_path):
    """Checkpoints are mesh-agnostic: written sharded, resumed unsharded."""
    scene, cam, env, cfg = _setup(spp=4)
    mesh = prender.make_mesh(8)
    s8 = RenderSession(scene, cam, env, cfg, chunk_samples=2, mesh=mesh)
    s8.step(2)
    path = str(tmp_path / "ckpt.npz")
    s8.checkpoint(path)

    s1 = RenderSession(scene, cam, env, cfg, chunk_samples=2)
    s1.restore(path)
    s1.step(2)

    ref = RenderSession(scene, cam, env, cfg, chunk_samples=2)
    ref.render_progressive(4)
    np.testing.assert_array_equal(np.asarray(s1.buffers()["beauty"]),
                                  np.asarray(ref.buffers()["beauty"]))


_WORKER = r"""
import os, sys, json
import numpy as np

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import jax
jax.config.update("jax_platforms", "cpu")
from raytracer_project_tpu.parallel import distributed, render as prender

distributed.init_distributed(coordinator_address=f"127.0.0.1:{port}",
                             num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == nproc * 4

from raytracer_project_tpu.models import camera as cam_mod, environment as env_mod, presets
from raytracer_project_tpu.ops import integrator

scene = presets.shirley_final_scene(grid=3, with_bvh=True)
cfg = integrator.RenderConfig(width=64, height=40, samples_per_pixel=2,
                              max_depth=5, env_mode=env_mod.PHYSICAL_SUN)
cam = cam_mod.make_camera(image_width=64, image_height=40, vfov=20.0,
                          lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0))
env = env_mod.make_environment()

mesh = distributed.make_global_mesh()
assert mesh.devices.size == nproc * 4
out = prender.render_sharded(scene, cam, env, jax.random.PRNGKey(0), cfg, mesh)
beauty = distributed.gather_to_host0(out["beauty"])
if distributed.is_host0():
    np.save(sys.argv[4], np.asarray(beauty))
print("WORKER_OK", pid)
"""



@pytest.mark.slow
def test_multiprocess_render_matches_single(tmp_path):
    """2 processes x 4 virtual CPU devices under jax.distributed render the
    same image as a plain single-process render."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    out_npy = str(tmp_path / "beauty.npy")
    env_vars = dict(os.environ)
    env_vars.pop("JAX_PLATFORMS", None)  # worker forces cpu via config
    # `python /tmp/.../worker.py` puts the script's directory on sys.path,
    # not the cwd — the package lives at the repo root, so point PYTHONPATH
    # there explicitly.
    env_vars["PYTHONPATH"] = REPO + os.pathsep + env_vars.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", str(port), out_npy],
            cwd=REPO, env=env_vars,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
        assert "WORKER_OK" in o

    multi = np.load(out_npy)

    scene, cam, env, _ = _setup(spp=2)
    cfg = integrator.RenderConfig(width=64, height=40, samples_per_pixel=2,
                                  max_depth=5, env_mode=env_mod.PHYSICAL_SUN)
    single = integrator.render(scene, cam, env, jax.random.PRNGKey(0), cfg)
    np.testing.assert_array_equal(multi, np.asarray(single["beauty"]))
