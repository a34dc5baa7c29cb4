"""Progressive render session: accumulate, preview, cancel, checkpoint.

JAX-native replacement for the reference's render-thread + dirty-flag state
machine (/root/reference/main.cpp:1395-1645, camera.hpp:209-343):

 * progressive accumulation in sample chunks (the accumulator persists
   across steps like camera.hpp:63; `current_samples_count` is real here,
   unlike the reference's never-used field camera.hpp:30)
 * cooperative cancellation between chunks (the reference checks its atomic
   flag per scanline, camera.hpp:441-443; here the jit step is the quantum)
 * checkpoint/resume of (accumulators, sample count, RNG key, configs) —
   the capability SURVEY §5.4 calls out as absent upstream
 * per-pass display/export through the differentiable post chain
   (camera.hpp:299-343 export parity)
 * progress/ETA + actual rays/s metrics (main.cpp:1399-1424)
 * mesh=... shards the step's pixel tiles over a jax device mesh
   (parallel/render.sharded_accumulate) with psum'd statistics — the
   multi-chip replacement for the reference's render-thread row fan-out
   (main.cpp:1520-1531); results are bit-identical to the unsharded
   session (tests/test_distributed.py)

The reference's dirty-flag trichotomy maps to:
  should_restart  -> RenderSession.reset() (new accumulator)
  needs_update    -> display()/export re-runs the post chain only
  needs_ui_sync   -> plain attribute reads (no hidden engine state)
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..core import colorspace
from ..models import camera as cam_mod
from ..ops import integrator, post as post_mod
from . import applog, image_io

PASS_BUFFERS = {
    post_mod.PASS_RGB: "beauty",
    post_mod.PASS_DENOISE: "beauty",   # denoiser applied at display time
    post_mod.PASS_ALBEDO: "albedo",
    post_mod.PASS_NORMALS: "normal",
    post_mod.PASS_REFLECTIONS: "reflection",
    post_mod.PASS_REFRACTIONS: "refraction",
    post_mod.PASS_Z_DEPTH: "z_depth",
}

PASS_NAMES = {
    post_mod.PASS_RGB: "rgb",
    post_mod.PASS_DENOISE: "denoise",
    post_mod.PASS_ALBEDO: "albedo",
    post_mod.PASS_NORMALS: "normals",
    post_mod.PASS_REFLECTIONS: "reflections",
    post_mod.PASS_REFRACTIONS: "refractions",
    post_mod.PASS_Z_DEPTH: "z_depth",
}


class RenderSession:
    """Owns the progressive accumulator; all compute stays functional."""

    def __init__(self, scene, camera: cam_mod.Camera,
                 env, config: integrator.RenderConfig,
                 post_params: post_mod.PostParams | None = None,
                 post_config: post_mod.PostConfig | None = None,
                 key=None, log: applog.AppLog | None = None,
                 mesh=None, chunk_samples: int = 4):
        self.scene = scene
        self.camera = camera
        self.env = env
        self.config = config
        self.post_params = post_params or post_mod.make_post_params()
        self.post_config = post_config or post_mod.PostConfig()
        self.key = key if key is not None else jax.random.PRNGKey(0)
        self.log = log or applog.AppLog()
        self.mesh = mesh
        self.chunk_samples = chunk_samples

        self._chunk_cfg = dataclasses.replace(config, samples_per_pixel=chunk_samples)
        if mesh is not None:
            # Pixel-tile sharding over the device mesh: the session's step
            # IS the multi-chip path (parallel/render.sharded_accumulate),
            # the counterpart of the reference's render-thread fan-out
            # (main.cpp:1520-1531). Pixel ids are padded to the shard
            # count; buffers()/checkpoint() slice the padding back off.
            import functools

            from ..parallel import render as prender

            self._ids = prender._padded_pixel_ids(
                config.n_pixels, mesh.devices.size)
            self._n_pad = int(self._ids.shape[0])
            # ids ride the CLOSURE (host numpy), not the jit arguments:
            # as a traced argument the clamped-identity pattern could not
            # be proven at trace time and every step would take the
            # gather-based pool instead of per-shard pixel windows.
            ids_np = self._ids
            base = jax.jit(
                lambda sc, ca, en, k, cfg, off: prender.sharded_accumulate(
                    sc, ca, en, k, cfg, ids_np, off, mesh=mesh,
                    with_stats=True),
                static_argnames=("cfg",),
            )
            self._step_fn = lambda sc, ca, en, k, cfg, ids, off: base(
                sc, ca, en, k, cfg, off)
        else:
            # Single-device sessions render the identity full frame:
            # pixel_ids=None asserts that STATICALLY through jit (an array
            # argument would be a tracer), so the pool skips its per-spawn
            # pixel gather.
            self._ids = None
            self._n_pad = config.n_pixels
            base = jax.jit(
                integrator.accumulate_samples,
                static_argnames=("config", "with_stats"),
            )
            self._step_fn = lambda sc, ca, en, k, cfg, ids, off: base(
                sc, ca, en, k, cfg, ids, off, with_stats=True)
        self.cancel_requested = False
        self._start_time: float | None = None
        self.reset()
        self.log.render("-Zenith-JAX engine session created (%dx%d)",
                        config.width, config.height)

    # -- accumulation -------------------------------------------------------

    def reset(self) -> None:
        """Zero all buffers + sample counter (camera.hpp:209-233)."""
        zeros = jnp.zeros((self._n_pad, 3), jnp.float32)
        self.acc = integrator.SampleBuffers(*([zeros] * 6))
        self.samples_done = 0
        self.segments_traced = 0.0
        self.cancel_requested = False
        self._start_time = None

    def step(self, n_samples: int | None = None) -> int:
        """Accumulate one chunk of samples; returns samples done so far."""
        n_samples = n_samples or self.chunk_samples
        cfg = (self._chunk_cfg if n_samples == self.chunk_samples
               else dataclasses.replace(self.config, samples_per_pixel=n_samples))
        if self._start_time is None:
            self._start_time = time.perf_counter()
        t0 = time.perf_counter()
        delta, stats = self._step_fn(self.scene, self.camera, self.env,
                                     self.key, cfg, self._ids,
                                     self.samples_done)
        self.acc = jax.tree.map(jnp.add, self.acc, delta)
        jax.block_until_ready(self.acc)
        dt = time.perf_counter() - t0
        self.samples_done += n_samples
        self.log.tick_frame()
        bound = applog.rays_per_second(self.config.width, self.config.height,
                                       n_samples, self.config.max_depth, dt)
        if stats.get("segments") is not None and float(stats["segments"]) > 0:
            # Pooled wavefront: the carry counts actually-traced segments.
            self.segments_traced += float(stats["segments"])
            measured = applog.measured_rays_per_second(
                float(stats["segments"]), dt)
            self.log.debug(
                "chunk %d samples in %.2fs (%.1f Mrays/s measured, "
                "%.1f bound)", n_samples, dt, measured / 1e6, bound / 1e6)
        else:
            self.log.debug("chunk %d samples in %.2fs (%.1f Mrays/s bound)",
                           n_samples, dt, bound / 1e6)
        return self.samples_done

    def render_progressive(self, total_samples: int,
                           callback=None) -> None:
        """Drive accumulation to `total_samples` with cancellation between
        chunks (the reference's per-scanline flag, camera.hpp:441-443)."""
        while self.samples_done < total_samples and not self.cancel_requested:
            n = min(self.chunk_samples, total_samples - self.samples_done)
            self.step(n)
            if callback is not None:
                callback(self)

    def cancel(self) -> None:
        """Cooperative stop; partial accumulators are preserved
        (main.cpp:1447-1461)."""
        self.cancel_requested = True
        self.log.render("Render cancelled at %d samples", self.samples_done)

    # -- progress / metrics (main.cpp:1399-1424) ---------------------------

    def progress(self, total_samples: int) -> float:
        return min(1.0, self.samples_done / max(total_samples, 1))

    def eta_seconds(self, total_samples: int) -> float:
        if self.samples_done == 0 or self._start_time is None:
            return float("inf")
        elapsed = time.perf_counter() - self._start_time
        rate = self.samples_done / elapsed
        return max(0.0, (total_samples - self.samples_done) / max(rate, 1e-9))

    # -- display / export ---------------------------------------------------

    def _acc_unpadded(self) -> integrator.SampleBuffers:
        n = self.config.n_pixels
        if self._n_pad == n:
            return self.acc
        return jax.tree.map(lambda x: x[:n], self.acc)

    def buffers(self) -> dict:
        """Averaged linear buffers [H, W, 3] (gathered to this host)."""
        total = max(self.samples_done, 1)
        acc = self._acc_unpadded()
        if jax.process_count() > 1:
            from ..parallel import distributed

            acc = integrator.SampleBuffers(
                *distributed.gather_to_host0(tuple(acc)))
        return integrator.finalize_buffers(acc, self.config,
                                           total_samples=total)

    def statistics(self) -> post_mod.ImageStatistics:
        if self.mesh is not None:
            # On-device psum'd reduction over the sharded accumulator —
            # no full-image host gather (SURVEY §5.8). Padding rows
            # duplicate pixel n-1 (< shard_count extra rows in 10^5+): a
            # negligible, deterministic bias accepted for a layout with
            # zero data movement.
            from ..parallel import render as prender

            img = self.acc.beauty / max(self.samples_done, 1)
            return prender.analyze_sharded(img, self.mesh)
        return post_mod.analyze_framebuffer(self.buffers()["beauty"])

    def resolved_exposure(self):
        """Auto-exposure result fed back into the grade
        (main.cpp:1589-1598)."""
        return post_mod.auto_exposure(self.post_params, self.statistics(),
                                      self.post_config)

    def display(self, current_pass: int = post_mod.PASS_RGB,
                denoise_specular: bool = False) -> np.ndarray:
        """Post-processed uint8 frame for preview (main.cpp:1538-1645).

        denoise_specular: also denoise the reflection/refraction passes
        with the albedo/normal guides, matching the reference's OIDN run
        over beauty AND the specular AOVs (camera.hpp:270-291).
        """
        buf = self.buffers()[PASS_BUFFERS[current_pass]]
        if current_pass == post_mod.PASS_DENOISE or (
            denoise_specular
            and current_pass in (post_mod.PASS_REFLECTIONS,
                                 post_mod.PASS_REFRACTIONS)
        ):
            from ..models import denoiser_unet
            from ..ops import denoise as denoise_mod

            b = self.buffers()
            # Learned model when the shipped weights exist (OIDN role,
            # camera.hpp:581-699); classical a-trous otherwise.
            buf = denoise_mod.denoise(
                b[PASS_BUFFERS[current_pass]], b["albedo"], b["normal"],
                model=denoiser_unet.load_default())
        params = self.post_params._replace(exposure=self.resolved_exposure())
        img = post_mod.update_post_processing(buf, params, self.post_config,
                                              current_pass)
        return np.asarray(jnp.clip(img * 255.999, 0.0, 255.0).astype(jnp.uint8))

    def display_wire(self, level: int = -1,
                     thickness: float = 0.01) -> np.ndarray:
        """Wireframe-over-the-live-render preview: BVH node edges
        composited INTO the beauty buffer, occlusion-correct at primary
        visibility (bvh.hpp:56-109 fabricated emissive hits blended with
        the scene; level/thickness are the reference's debug sliders,
        main.cpp:1058-1085)."""
        from ..ops import debugviz

        if self.scene.bvh is None:
            raise ValueError("scene has no BVH (build with with_bvh=True)")
        comp = debugviz.composite_wireframe(
            self.scene, self.camera, self.buffers()["beauty"],
            level=level, thickness=thickness)
        params = self.post_params._replace(exposure=self.resolved_exposure())
        img = post_mod.update_post_processing(comp, params,
                                              self.post_config,
                                              post_mod.PASS_RGB)
        return np.asarray(jnp.clip(img * 255.999, 0.0, 255.0)
                          .astype(jnp.uint8))

    def save_render_pass(self, current_pass: int, path: str) -> str:
        """PNG export of one pass (camera.hpp:299-343)."""
        image_io.save_png(path, self.display(current_pass))
        self.log.system("Saved %s pass to %s", PASS_NAMES[current_pass], path)
        return path

    def save_all_passes(self, out_dir: str = "output") -> list[str]:
        """Batch export of all buffers (main.cpp:1327-1355)."""
        paths = []
        for pass_id, name in PASS_NAMES.items():
            if pass_id == post_mod.PASS_DENOISE:
                continue
            paths.append(self.save_render_pass(
                pass_id, os.path.join(out_dir, f"render_{name}.png")
            ))
        return paths

    # -- checkpoint / resume (SURVEY §5.4 — new capability) -----------------

    def checkpoint(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        acc = self._acc_unpadded()  # mesh-agnostic on disk
        np.savez_compressed(
            path,
            beauty=np.asarray(acc.beauty),
            albedo=np.asarray(acc.albedo),
            normal=np.asarray(acc.normal),
            z_depth=np.asarray(acc.z_depth),
            reflection=np.asarray(acc.reflection),
            refraction=np.asarray(acc.refraction),
            key=np.asarray(self.key),
            samples_done=self.samples_done,
            config=json.dumps(dataclasses.asdict(self.config)),
        )
        self.log.system("Checkpointed %d samples to %s", self.samples_done, path)
        return path

    def restore(self, path: str) -> None:
        data = np.load(path, allow_pickle=False)
        stored = json.loads(str(data["config"]))
        current = dataclasses.asdict(self.config)
        if stored != current:
            raise ValueError(
                f"checkpoint config mismatch: {stored} != {current}"
            )
        def load(k):
            arr = np.asarray(data[k])
            pad = self._n_pad - arr.shape[0]
            if pad > 0:  # re-pad for the sharded layout (duplicate rows
                # are never read back: buffers() slices them off)
                arr = np.concatenate([arr, np.zeros((pad, 3), arr.dtype)])
            return jnp.asarray(arr)

        self.acc = integrator.SampleBuffers(
            *[load(k) for k in
              ("beauty", "albedo", "normal", "z_depth", "reflection",
               "refraction")]
        )
        self.key = jnp.asarray(data["key"])
        self.samples_done = int(data["samples_done"])
        self.log.system("Restored %d samples from %s", self.samples_done, path)
