"""Train the compact denoiser U-Net on renders from this engine.

Data: (8 spp noisy + albedo + normal) -> 256 spp target pairs over
randomized shirley-style scenes, the cornell box, and the showcase scene.
Pairs are cached to /tmp/denoiser_data so re-runs skip the renders.

Run from the repo root:  python - < tools/train_denoiser.py
Env: DN_STEPS (default 800), DN_PAIRS (default 14).
Writes raytracer_project_tpu/assets/denoiser_weights.npz.
"""
import os
import sys
import time

import jax

if os.environ.get("DN_CPU", "1") == "1":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.getcwd())

from raytracer_project_tpu.models import camera as cam_mod
from raytracer_project_tpu.models import denoiser_unet as unet
from raytracer_project_tpu.models import environment as env_mod
from raytracer_project_tpu.models import presets
from raytracer_project_tpu.ops import integrator
from raytracer_project_tpu.utils import metrics

W, H = 96, 54
LOW, HIGH = 8, 256
CACHE = "/tmp/denoiser_data"
os.makedirs(CACHE, exist_ok=True)


def render(scene, cam, env, mode, spp, key):
    cfg = integrator.RenderConfig(
        width=W, height=H, samples_per_pixel=spp, max_depth=8, env_mode=mode,
        use_albedo=True, use_normal=True, use_z_depth=False, wavefront=True)
    out = jax.jit(integrator.render, static_argnames="config")(
        scene, cam, env, key, cfg)
    return {k: np.asarray(out[k]).reshape(H, W, 3)
            for k in ("beauty", "albedo", "normal")}


def make_case(i):
    r = np.random.default_rng(100 + i)
    kind = i % 3
    if kind == 0:
        scene = presets.shirley_final_scene(seed=int(r.integers(1, 99)),
                                            grid=int(r.integers(3, 7)),
                                            with_bvh=False)
        dist = 10.0 + r.uniform(-2, 4)
        cam = cam_mod.make_camera(
            image_width=W, image_height=H, vfov=float(r.uniform(18, 32)),
            lookfrom=(13 + r.uniform(-3, 3), 2 + r.uniform(0, 2),
                      3 + r.uniform(-2, 2)),
            lookat=(0, 0, 0), defocus_angle=float(r.uniform(0, 0.6)),
            focus_dist=dist)
        env = env_mod.make_environment(
            sun_direction=(r.uniform(0.1, 0.7), r.uniform(0.3, 0.9),
                           r.uniform(0.0, 0.5)),
            sun_intensity=float(r.uniform(3, 8)))
        return scene, cam, env, env_mod.PHYSICAL_SUN
    if kind == 1:
        scene = presets.cornell_box_scene(with_bvh=False)
        cam = cam_mod.make_camera(
            image_width=W, image_height=H, vfov=float(r.uniform(35, 45)),
            lookfrom=(278 + r.uniform(-60, 60), 278 + r.uniform(-60, 60),
                      -800 + r.uniform(-60, 120)),
            lookat=(278, 278, 0))
        env = env_mod.make_environment(background_color=(0, 0, 0))
        return scene, cam, env, env_mod.SOLID_COLOR
    scene = presets.showcase_scene(seed=int(r.integers(1, 99)),
                                   with_bvh=False, with_meshes=True)
    cam = cam_mod.make_camera(
        image_width=W, image_height=H, vfov=30.0,
        lookfrom=(12 + r.uniform(-2, 2), 2.5 + r.uniform(-0.5, 1.5),
                  6 + r.uniform(-2, 2)),
        lookat=(0, 1, 0))
    env = env_mod.make_environment(
        sun_direction=(r.uniform(0.2, 0.6), r.uniform(0.4, 0.9),
                       r.uniform(0.0, 0.4)),
        sun_intensity=float(r.uniform(4, 8)))
    return scene, cam, env, env_mod.PHYSICAL_SUN


def get_pair(i):
    path = os.path.join(CACHE, f"pair_{i:02d}.npz")
    if os.path.exists(path):
        d = np.load(path)
        return {k: d[k] for k in d.files}
    scene, cam, env, mode = make_case(i)
    key = jax.random.PRNGKey(1000 + i)
    lo = render(scene, cam, env, mode, LOW, key)
    hi = render(scene, cam, env, mode, HIGH, key)
    pair = {"beauty": lo["beauty"], "albedo": lo["albedo"],
            "normal": lo["normal"], "target": hi["beauty"]}
    np.savez(path, **pair)
    print(f"[data] rendered pair {i}", flush=True)
    return pair


def main():
    n_pairs = int(os.environ.get("DN_PAIRS", "14"))
    steps = int(os.environ.get("DN_STEPS", "800"))
    t0 = time.time()
    pairs = [get_pair(i) for i in range(n_pairs)]
    print(f"[data] {n_pairs} pairs in {time.time()-t0:.0f}s", flush=True)
    train, val = pairs[:-2], pairs[-2:]

    stack = lambda ps, k: jnp.asarray(np.stack([p[k] for p in ps]))
    tb, ta, tn, tt = (stack(train, k)
                      for k in ("beauty", "albedo", "normal", "target"))

    params = unet.init_params(0)
    print("[train] params:", unet.param_count(params), flush=True)

    import optax
    sched = optax.cosine_decay_schedule(2e-3, steps, alpha=0.05)
    opt = optax.adam(sched)
    opt_state = opt.init(params)

    # Random-crop + flip augmentation: 64x32 patches (multiples of 4 for
    # the two downsamples) sampled fresh each step.
    PH, PW, PER_IMG = 32, 64, 4

    def crops(key, b, a, n, t):
        n_img = b.shape[0]
        k1, k2, k3 = jax.random.split(key, 3)
        img = jax.random.randint(k1, (n_img * PER_IMG,), 0, n_img)
        oy = jax.random.randint(k2, (n_img * PER_IMG,), 0, H - PH)
        ox = jax.random.randint(k3, (n_img * PER_IMG,), 0, W - PW)
        flip = jax.random.bernoulli(k1, 0.5, (n_img * PER_IMG,))

        def take(src):
            def one(i, y, x, f):
                patch = jax.lax.dynamic_slice(src[i], (y, x, 0), (PH, PW, 3))
                return jnp.where(f, patch[:, ::-1], patch)
            return jax.vmap(one)(img, oy, ox, flip)
        return take(b), take(a), take(n), take(t)

    def loss_fn(params, key):
        b, a, n, t = crops(key, tb, ta, tn, tt)
        pred = jax.vmap(lambda bb, aa, nn: unet.apply(params, bb, aa, nn))(
            b, a, n)
        return jnp.mean(jnp.abs(jnp.log1p(pred) - jnp.log1p(t)))

    @jax.jit
    def step(params, opt_state, key):
        loss, g = jax.value_and_grad(loss_fn)(params, key)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    key = jax.random.PRNGKey(7)
    for s in range(steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, sub)
        if s % 200 == 0 or s == steps - 1:
            print(f"[train] step {s}: loss {float(loss):.5f} "
                  f"({time.time()-t0:.0f}s)", flush=True)

    # Validation vs the a-trous baseline.
    from raytracer_project_tpu.ops import denoise as dn
    for j, p in enumerate(val):
        pred = np.asarray(unet.apply(params, p["beauty"], p["albedo"],
                                     p["normal"]))
        at = np.asarray(dn.atrous_denoise(p["beauty"], p["albedo"],
                                          p["normal"]))
        print(f"[val {j}] raw {float(metrics.psnr(p['beauty'], p['target'])):.2f} "
              f"atrous {float(metrics.psnr(at, p['target'])):.2f} "
              f"unet {float(metrics.psnr(pred, p['target'])):.2f} dB",
              flush=True)

    out = os.path.join("raytracer_project_tpu", "assets",
                       "denoiser_weights.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    unet.save_params(out, params)
    print("[done] saved", out, flush=True)


if __name__ == "__main__":
    main()
