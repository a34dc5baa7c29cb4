"""Command-line interface: render / bench / info.

The reference is an interactive SDL+ImGui binary (main.cpp); the JAX-native
framework is a library + this CLI (SURVEY §7 decision 7: all *capabilities*
of the UI — pass selection, progress/ETA, cancellation, export, logs — as
library/CLI features).

    python -m raytracer_project_tpu render --preset showcase --spp 64
    python -m raytracer_project_tpu render --scene-file scene.json \
        --passes rgb,albedo,normals --out output/
    python -m raytracer_project_tpu bench
    python -m raytracer_project_tpu info
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracer_project_tpu")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render a scene to PNG passes")
    r.add_argument("--preset", default=None,
                   choices=["showcase", "shirley", "cornell"],
                   help="built-in scene (models/presets.py)")
    r.add_argument("--scene-file", default=None,
                   help="JSON scene document (models/sceneio.py schema)")
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--height", type=int, default=None)
    r.add_argument("--spp", type=int, default=None,
                   help="samples per pixel (reference default 30)")
    r.add_argument("--max-depth", type=int, default=None)
    r.add_argument("--passes", default="rgb",
                   help="comma list: rgb,denoise,albedo,normals,"
                        "reflections,refractions,z_depth,all")
    r.add_argument("--out", default="output", help="output directory")
    r.add_argument("--checkpoint", default=None,
                   help="checkpoint file; written after the render and, with "
                        "--resume, restored before it")
    r.add_argument("--resume", action="store_true")
    r.add_argument("--chunk", type=int, default=4,
                   help="samples per progressive chunk")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--devices", type=int, default=None,
                   help="shard pixel tiles over this many devices "
                        "(default: 1; pass 0 for all visible devices)")
    r.add_argument("--quiet", action="store_true")
    r.add_argument("--watch", default=None, metavar="PNG",
                   help="progressive preview: rewrite this PNG with the "
                        "current post-processed beauty every ~150 ms of "
                        "render time and log a histogram line per update "
                        "(main.cpp:1538-1645 live-preview parity)")
    r.add_argument("--watch-interval", type=float, default=0.15,
                   help="minimum seconds between --watch updates "
                        "(reference cadence 150 ms, main.cpp:1556)")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler device trace of the render "
                        "into DIR (open with TensorBoard / xprof)")
    r.add_argument("--check-numerics", action="store_true",
                   help="render one debug chunk under checkify NaN/Inf "
                        "traps before the real render (slow; small frames)")

    i = sub.add_parser(
        "interactive",
        help="adjust-while-rendering control loop (type `help` at the "
             "prompt; the reference's ImGui panel as a command channel)")
    i.add_argument("--preset", default="showcase",
                   choices=["showcase", "shirley", "cornell"])
    i.add_argument("--scene-file", default=None,
                   help="JSON scene; watched for edits between chunks")
    i.add_argument("--width", type=int, default=400)
    i.add_argument("--height", type=int, default=225)
    i.add_argument("--spp", type=int, default=30,
                   help="progressive target (camera.hpp:27 default)")
    i.add_argument("--chunk", type=int, default=2)
    i.add_argument("--seed", type=int, default=0)
    i.add_argument("--watch", default="output/preview.png", metavar="PNG",
                   help="live preview PNG (0.15 s cadence, main.cpp:1556)")

    b = sub.add_parser("bench", help="run the standard benchmark")
    b.add_argument("--spp", type=int, default=32)

    sub.add_parser("info", help="devices, native library, versions")
    return p


def _passes(arg: str):
    from .ops import post as post_mod
    from .utils.session import PASS_NAMES

    by_name = {v: k for k, v in PASS_NAMES.items()}
    if arg.strip() == "all":
        return [p for p in PASS_NAMES if p != post_mod.PASS_DENOISE]
    out = []
    for name in arg.split(","):
        name = name.strip()
        if name not in by_name:
            raise SystemExit(f"unknown pass '{name}'; "
                             f"choose from {sorted(by_name)} or 'all'")
        out.append(by_name[name])
    return out


def _cmd_render(args) -> int:
    import jax

    from .models import camera as cam_mod
    from .models import environment as env_mod
    from .models import presets, sceneio
    from .ops import integrator, post as post_mod
    from .utils import applog
    from .utils.session import PASS_NAMES, RenderSession

    log = applog.AppLog(echo=not args.quiet)

    if args.scene_file:
        scene, cam, env, config = sceneio.load_scene_file(args.scene_file)
    else:
        preset = args.preset or "showcase"
        if preset == "showcase":
            scene = presets.showcase_scene()
            lookfrom, lookat, vfov = (12.0, 2.5, 6.0), (0.0, 1.0, 0.0), 30.0
        elif preset == "shirley":
            scene = presets.shirley_final_scene()
            lookfrom, lookat, vfov = (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), 20.0
        else:
            scene = presets.cornell_box_scene()
            lookfrom, lookat, vfov = (278.0, 278.0, -800.0), (278.0, 278.0, 0.0), 40.0
        config = integrator.RenderConfig(env_mode=env_mod.PHYSICAL_SUN)
        env = env_mod.make_environment()
        cam = None  # built after config overrides below

    # CLI overrides.
    overrides = {}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.spp:
        overrides["samples_per_pixel"] = args.spp
    if args.max_depth:
        overrides["max_depth"] = args.max_depth
    pass_ids = _passes(args.passes)
    overrides["use_reflection"] = post_mod.PASS_REFLECTIONS in pass_ids
    overrides["use_refraction"] = post_mod.PASS_REFRACTIONS in pass_ids
    config = dataclasses.replace(config, **overrides)
    if cam is None:
        cam = cam_mod.make_camera(
            image_width=config.width, image_height=config.height, vfov=vfov,
            lookfrom=lookfrom, lookat=lookat, defocus_angle=0.0,
            focus_dist=10.0,
        )

    mesh = None
    if args.devices is not None:
        from .parallel import distributed, render as prender

        distributed.init_distributed()  # no-op single-process
        mesh = prender.make_mesh(args.devices or None)
        log.system("Pixel tiles sharded over %d device(s)", mesh.devices.size)

    sess = RenderSession(scene, cam, env, config, log=log,
                         key=jax.random.PRNGKey(args.seed),
                         chunk_samples=args.chunk, mesh=mesh)
    if args.resume and args.checkpoint:
        try:
            sess.restore(args.checkpoint)
        except (OSError, ValueError) as e:
            log.error("resume failed (%s); starting fresh", e)

    total = config.samples_per_pixel
    t0 = time.perf_counter()

    watch_state = {"last": 0.0}

    def progress(s):
        if args.watch and (time.perf_counter() - watch_state["last"]
                           >= args.watch_interval):
            # Throttled accumulator -> post -> file preview, the CLI twin
            # of the reference's 150 ms texture upload (main.cpp:1538-1645)
            # plus its histogram panel (main.cpp:1130-1165) as one line.
            from .utils import histview, image_io

            image_io.save_png(args.watch, s.display(post_mod.PASS_RGB))
            stats = s.statistics()
            hist = histview.ascii_histogram(
                stats, target_luminance=float(
                    s.post_params.target_luminance))
            log.render("watch %s @ %d spp\n%s", args.watch, s.samples_done,
                       hist)
            watch_state["last"] = time.perf_counter()
        if args.quiet:
            return
        pct = 100.0 * s.progress(total)
        eta = s.eta_seconds(total)
        sys.stderr.write(
            f"\r[{pct:5.1f}%] {s.samples_done}/{total} spp  "
            f"ETA {eta:6.1f}s"
        )
        sys.stderr.flush()

    if args.check_numerics:
        # One tiny chunk under checkify float traps (SURVEY §5.2): raises
        # with a located error on the first hidden NaN/Inf instead of
        # scrub-and-continue.
        import dataclasses as _dc
        import functools as _ft

        from .utils import debug as debug_mod

        dbg_cfg = _dc.replace(config, samples_per_pixel=1, wavefront=False)
        dbg = debug_mod.checked(_ft.partial(
            integrator.render, config=dbg_cfg))
        dbg(scene, cam, env, jax.random.PRNGKey(args.seed))
        log.debug("checkify numerics pass clean (1 spp probe)")

    if args.profile:
        with jax.profiler.trace(args.profile):
            sess.render_progressive(total, callback=progress)
        log.system("Profiler trace written to %s", args.profile)
    else:
        sess.render_progressive(total, callback=progress)
    if not args.quiet:
        sys.stderr.write("\n")
    dt = time.perf_counter() - t0
    log.render("Rendered %d spp in %.3fs (%.2f Mrays/s bound; %.0f path "
               "segments traced, %.2f M segments/s)", sess.samples_done,
               dt, applog.rays_per_second(config.width, config.height,
                                          sess.samples_done,
                                          config.max_depth, dt) / 1e6,
               sess.segments_traced, sess.segments_traced / dt / 1e6)

    if args.checkpoint:
        sess.checkpoint(args.checkpoint)
    import os

    for pid in pass_ids:
        path = os.path.join(args.out, f"render_{PASS_NAMES[pid]}.png")
        sess.save_render_pass(pid, path)
        print(path)
    return 0


def _cmd_bench(args) -> int:
    import os
    import runpy

    os.environ.setdefault("BENCH_SPP", str(args.spp))
    sys.argv = ["bench.py"]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runpy.run_path(os.path.join(here, "bench.py"), run_name="__main__")
    return 0


def _cmd_info() -> int:
    import jax

    from . import __version__, native

    info = {
        "version": __version__,
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
        "native": native.available(),
    }
    print(json.dumps(info, indent=2))
    return 0


def _cmd_interactive(args) -> int:
    import jax

    from .models import camera as cam_mod  # noqa: F401 (env setup parity)
    from .models import environment as env_mod
    from .models import presets, sceneio
    from .ops import integrator
    from .utils import applog
    from .utils.interactive import InteractiveLoop

    log = applog.AppLog(echo=True)
    camera_params = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0),
                         lookat=(0.0, 1.0, 0.0), defocus_angle=0.0,
                         focus_dist=10.0)
    if args.scene_file:
        scene, cam, env, config = sceneio.load_scene_file(args.scene_file)
    else:
        if args.preset == "showcase":
            scene = presets.showcase_scene()
        elif args.preset == "shirley":
            scene = presets.shirley_final_scene()
            camera_params.update(vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
                                 lookat=(0.0, 0.0, 0.0))
        else:
            scene = presets.cornell_box_scene()
            camera_params.update(vfov=40.0,
                                 lookfrom=(278.0, 278.0, -800.0),
                                 lookat=(278.0, 278.0, 0.0))
        env = env_mod.make_environment()
        config = integrator.RenderConfig(env_mode=env_mod.PHYSICAL_SUN)
    config = dataclasses.replace(config, width=args.width,
                                 height=args.height,
                                 samples_per_pixel=args.spp)
    loop = InteractiveLoop(
        scene, env, config, camera_params, log=log,
        key=jax.random.PRNGKey(args.seed), chunk_samples=args.chunk,
        scene_file=args.scene_file, watch_png=args.watch,
    )
    print(f"interactive: preview -> {args.watch}; type `help`",
          file=sys.stderr)
    loop.run()
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "render":
        return _cmd_render(args)
    if args.command == "interactive":
        return _cmd_interactive(args)
    if args.command == "bench":
        return _cmd_bench(args)
    return _cmd_info()


if __name__ == "__main__":
    sys.exit(main())
