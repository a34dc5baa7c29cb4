"""Closest-hit route timings on one GPU: the brute-force scan vs threaded
BVH traversal, across scene sizes on both sides of intersect.BVH_MIN_PRIMS.

Each route is jitted, compiled, warmed, and timed with block_until_ready
on 262,144 rays (camera rays plus one bounce, chip_smoke's ray set). The
data behind intersect.BVH_MIN_PRIMS; the timings go to PERF.md beside the
card's name and power limit.

Run from the repo root on the card:
    python tools/bench_routes.py [--out chiprun_out/bench_routes.json]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# (label, scene constructor kwargs): the showcase, then funnels of growing
# size (spheres + tessellated tori).
CASES = [
    ("showcase", None),
    ("funnel", dict(n_spheres=8192, mesh_detail=2)),
    ("funnel", dict(n_spheres=16384, mesh_detail=4)),
    ("funnel", dict(n_spheres=32768, mesh_detail=8)),
]
REPS = 5


def time_route(fn, scene, o, d):
    exe, compile_s = chip_smoke.compiled(fn, scene, o, d)
    hit, _ = chip_smoke.run_timed(exe, scene, o, d)
    walls = [chip_smoke.run_timed(exe, scene, o, d)[1] for _ in range(REPS)]
    return hit, compile_s, walls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "bench_routes.json"))
    args = ap.parse_args(argv)

    from raytracer_project_tpu.core.constants import T_MIN
    from raytracer_project_tpu.ops import intersect, traverse
    from raytracer_project_tpu.utils import device

    devs = device.require_gpu()
    cards = device.card_lines()
    for line in cards:
        print(f"card: {line}", flush=True)
    routes = {
        "brute": lambda s, o, d: intersect.intersect_brute(s, o, d, T_MIN),
        "bvh": lambda s, o, d: traverse.intersect_bvh(s, o, d, T_MIN),
    }
    rows = []
    for kind, kw in CASES:
        t0 = time.perf_counter()
        if kind == "showcase":
            scene, cam, _ = chip_smoke.showcase(512, 256)
        else:
            scene, cam, _ = chip_smoke.funnel(512, 256, **kw)
        build_s = time.perf_counter() - t0
        o, d = chip_smoke.camera_and_bounce_rays(scene, cam, 512, 256)
        ref = None
        for name, fn in routes.items():
            hit, compile_s, walls = time_route(fn, scene, o, d)
            row = {"scene": kind, "scene_kw": kw,
                   "primitives": int(scene.primitive_count),
                   "route": name, "rays": int(o.shape[0]),
                   "compile_s": compile_s, "wall_ms": [w * 1e3 for w in walls],
                   "median_ms": sorted(walls)[REPS // 2] * 1e3,
                   "scene_build_s": build_s,
                   "dispatch": intersect.intersect_dispatch(scene)}
            if ref is None:
                ref = hit
            else:
                row.update(chip_smoke.hit_stats(hit, ref))
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"cards": cards,
                   "device": device.device_summary(devs), "rows": rows},
                  f, indent=1)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
