"""Generate the CPU goldens chip_smoke.py's goldens phase compares against.

Run from the repo root:  python tools/make_smoke_goldens.py

Renders chip_smoke.golden_renders() (showcase frames through the pooled
wavefront, integrator.render) on the CPU backend and stores each image as
tests/goldens/smoke_<name>.npz. Regenerate ONLY on an intentional
image-affecting change, and say so in the commit message.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402


def main():
    images = chip_smoke.render_golden_images(chip_smoke.golden_renders())
    for name, img in images.items():
        assert np.isfinite(img).all() and img.max() > 0, name
        path = os.path.join(chip_smoke.GOLDEN_DIR, f"{name}.npz")
        np.savez_compressed(path, beauty=img)
        print(f"{name}: {img.shape} mean={img.mean():.4f} -> {path}")


if __name__ == "__main__":
    main()
