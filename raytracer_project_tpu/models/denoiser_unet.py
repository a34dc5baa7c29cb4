"""Learned denoiser: a compact residual U-Net on (beauty, albedo, normal).

The counterpart of the reference's Intel OIDN filter
(/root/reference/camera.hpp:581-699): same 3-buffer input contract
(camera.hpp:640-648), implemented as a small pure-JAX U-Net (plain
parameter pytrees — no framework dependency) that predicts a residual
correction to the noisy beauty in log space. Weights ship as an .npz
(assets/denoiser_weights.npz, trained by tools/train_denoiser.py on
renders from this engine); `load_default()` returns a callable matching
the ops.denoise.denoise(model=...) hook.

Architecture: 2-level U-Net, 3x3 convs + leaky ReLU, stride-2 downsample,
nearest-neighbor upsample with skip concatenation (~70k params). The convs
run at HIGHEST precision: float32 at default precision may run in TF32 on
a GPU, and the quality tests were calibrated in full float32.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

# channel widths per level
_C0, _C1, _C2 = 24, 48, 96
_IN_CH = 9   # beauty(3) + albedo(3) + normal(3)


def _conv(x, w, b, stride: int = 1):
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    y = jax.lax.conv_general_dilated(
        x, w, window_strides=(stride, stride), padding="SAME",
        dimension_numbers=dn, precision=jax.lax.Precision.HIGHEST)
    return y + b


def _act(x):
    return jax.nn.leaky_relu(x, 0.1)


def _upsample2(x):
    n, h, w, c = x.shape
    x = jnp.broadcast_to(x[:, :, None, :, None, :], (n, h, 2, w, 2, c))
    return jnp.reshape(x, (n, h * 2, w * 2, c))


_LAYERS = [
    # name, (kh, kw, cin, cout), stride
    ("enc0a", (3, 3, _IN_CH, _C0), 1),
    ("enc0b", (3, 3, _C0, _C0), 1),
    ("down1", (3, 3, _C0, _C1), 2),
    ("enc1a", (3, 3, _C1, _C1), 1),
    ("down2", (3, 3, _C1, _C2), 2),
    ("bottle", (3, 3, _C2, _C2), 1),
    ("dec1a", (3, 3, _C2 + _C1, _C1), 1),
    ("dec1b", (3, 3, _C1, _C1), 1),
    ("dec0a", (3, 3, _C1 + _C0, _C0), 1),
    ("dec0b", (3, 3, _C0, _C0), 1),
    ("out", (3, 3, _C0, 3), 1),
]


def init_params(seed: int = 0) -> dict:
    """He-initialized parameter pytree (numpy host-side)."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape, _ in _LAYERS:
        fan_in = shape[0] * shape[1] * shape[2]
        params[f"{name}.w"] = jnp.asarray(
            rng.normal(0.0, np.sqrt(2.0 / fan_in), shape), jnp.float32)
        params[f"{name}.b"] = jnp.zeros((shape[3],), jnp.float32)
    return params


def param_count(params) -> int:
    return int(sum(np.prod(v.shape) for v in params.values()))


def apply(params: dict, beauty, albedo, normal):
    """Denoise [H, W, 3] buffers -> [H, W, 3].

    Works at any resolution (inputs are padded to a multiple of 4 for the
    two downsamples). The network sees log1p(beauty) and predicts a
    residual in that domain, so output brightness is anchored to the input.
    """
    h, w = beauty.shape[0], beauty.shape[1]
    ph = (-h) % 4
    pw = (-w) % 4
    pad = lambda img: jnp.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    lb = jnp.log1p(jnp.maximum(pad(beauty), 0.0))
    x = jnp.concatenate([lb, pad(albedo), pad(normal)], axis=-1)[None]

    cv = lambda n, t, s=1: _act(_conv(t, params[f"{n}.w"], params[f"{n}.b"], s))
    e0 = cv("enc0b", cv("enc0a", x))
    e1 = cv("enc1a", cv("down1", e0, 2))
    b = cv("bottle", cv("down2", e1, 2))
    d1 = cv("dec1b", cv("dec1a", jnp.concatenate([_upsample2(b), e1], -1)))
    d0 = cv("dec0b", cv("dec0a", jnp.concatenate([_upsample2(d1), e0], -1)))
    res = _conv(d0, params["out.w"], params["out.b"])
    out = jnp.expm1(jnp.maximum(lb + res[0], 0.0))
    return out[:h, :w]


_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "assets",
                                "denoiser_weights.npz")


def load_params(path: str) -> dict:
    data = np.load(path)
    return {k: jnp.asarray(data[k]) for k in data.files}


def save_params(path: str, params: dict) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_default():
    """Callable for ops.denoise.denoise(model=...), or None if the shipped
    weights are absent (source checkouts without the trained asset)."""
    path = os.environ.get("RAYTRACER_TPU_DENOISER", _DEFAULT_WEIGHTS)
    if not os.path.exists(path):
        return None
    params = load_params(path)
    return lambda beauty, albedo, normal: apply(params, beauty, albedo,
                                                normal)
