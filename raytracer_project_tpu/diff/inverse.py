"""Inverse rendering: select parameters by path, differentiate, optimize.

Replaces nothing in the reference — the C++ engine has no gradient story at
all; this is the capability the JAX-native redesign adds on top (the scene
being a pytree of SoA jnp arrays, models/scene.py, is what makes it free).

Typical use:

    state = RenderState(scene=scene, cam=cam, env=env)
    paths = ["scene.materials.albedo", "env.sun_intensity"]
    fitted, losses = fit(state, key, config, target, paths, steps=200)

Every step renders with the *same* base key (a frozen sample pattern), so
the loss surface is deterministic and finite-difference checks agree with
`jax.grad` — see tests/test_gradients.py. Pass `resample_keys=True` to
fold the step index into the key instead (stochastic gradient descent over
sample patterns; lower-variance fits at high step counts).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp

from ..models import camera as camera_mod
from ..models import environment as env_mod
from ..models.scene import Scene
from ..ops import integrator


class RenderState(NamedTuple):
    """The full differentiable input of one render (a pytree)."""

    scene: Scene
    cam: camera_mod.Camera
    env: env_mod.Environment


# ---------------------------------------------------------------------------
# Dotted-path access into nested NamedTuple pytrees
# ---------------------------------------------------------------------------

def tree_get(root: Any, path: str):
    """Fetch a leaf/subtree by dotted path, e.g. "scene.materials.albedo"."""
    obj = root
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def tree_set(root: Any, path: str, value: Any):
    """Functionally replace the leaf at `path` (NamedTuple _replace chain)."""
    parts = path.split(".")

    def rec(obj, parts):
        if len(parts) == 1:
            return obj._replace(**{parts[0]: value})
        child = getattr(obj, parts[0])
        return obj._replace(**{parts[0]: rec(child, parts[1:])})

    return rec(root, parts)


def extract_params(state: RenderState, paths: Sequence[str]) -> dict:
    """{path: leaf} for the selected differentiable parameters."""
    return {p: tree_get(state, p) for p in paths}


def apply_params(state: RenderState, params: dict) -> RenderState:
    """Write {path: leaf} values back into the state."""
    for p, v in params.items():
        state = tree_set(state, p, v)
    return state


# ---------------------------------------------------------------------------
# Differentiable forward + losses
# ---------------------------------------------------------------------------

def render_beauty(state: RenderState, key, config: integrator.RenderConfig):
    """Beauty image [H, W, 3]; pure/differentiable in every state leaf.

    Forces `config.differentiable=True` (bounded bounce loop) so reverse-mode
    AD works regardless of how the caller built the config.
    """
    import dataclasses

    if not config.differentiable:
        config = dataclasses.replace(config, differentiable=True)
    out = integrator.render(state.scene, state.cam, state.env, key, config)
    return out["beauty"]


def image_loss(rendered, target, kind: str = "l2"):
    """Scalar image loss. "l2" = MSE; "l1"; "relative" = MSE / (target²+eps)
    (the classic Mitsuba-style relative loss, robust to HDR dynamic range)."""
    diff = rendered - target
    if kind == "l2":
        return jnp.mean(diff * diff)
    if kind == "l1":
        return jnp.mean(jnp.abs(diff))
    if kind == "relative":
        return jnp.mean(diff * diff / (jax.lax.stop_gradient(rendered) ** 2 + 1e-2))
    raise ValueError(f"unknown loss kind: {kind}")


def make_loss_fn(state: RenderState, config: integrator.RenderConfig,
                 target, paths: Sequence[str], loss_kind: str = "l2"):
    """Returns (loss_fn(params, key) -> scalar, initial params dict)."""
    params0 = extract_params(state, paths)

    def loss_fn(params, key):
        s = apply_params(state, params)
        img = render_beauty(s, key, config)
        return image_loss(img, target, loss_kind)

    return loss_fn, params0


# ---------------------------------------------------------------------------
# Optimization loop
# ---------------------------------------------------------------------------

def fit(
    state: RenderState,
    key,
    config: integrator.RenderConfig,
    target,
    paths: Sequence[str],
    *,
    steps: int = 100,
    learning_rate: float = 2e-2,
    optimizer=None,
    loss_kind: str = "l2",
    project: Callable[[dict], dict] | None = None,
    resample_keys: bool = False,
    callback: Callable[[int, float], None] | None = None,
):
    """Gradient-descend the selected parameters toward the target image.

    project: optional constraint map applied to params after each update
    (e.g. clip albedos into [0, 1]). Returns (fitted_state, losses list).
    """
    import optax

    if optimizer is None:
        optimizer = optax.adam(learning_rate)

    loss_fn, params = make_loss_fn(state, config, target, paths, loss_kind)
    opt_state = optimizer.init(params)

    @jax.jit
    def step_fn(params, opt_state, step_key):
        loss, grads = jax.value_and_grad(loss_fn)(params, step_key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    losses = []
    for i in range(steps):
        step_key = jax.random.fold_in(key, i) if resample_keys else key
        params, opt_state, loss = step_fn(params, opt_state, step_key)
        if project is not None:
            params = project(params)
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1])

    return apply_params(state, params), losses


def finite_difference_grad(loss_fn, params: dict, path: str, index,
                           key, eps: float = 1e-3) -> float:
    """Central finite difference of loss_fn w.r.t. params[path][index].

    The gradient-parity oracle (BASELINE.md "gradient parity" row): used by
    tests to validate jax.grad against the underlying loss surface.
    """
    leaf = params[path]
    flat = jnp.ravel(leaf)
    i = int(jnp.ravel(jnp.asarray(index))[0]) if not isinstance(index, int) else index

    def eval_at(delta):
        p = dict(params)
        p[path] = jnp.reshape(flat.at[i].add(delta), leaf.shape)
        return float(loss_fn(p, key))

    return (eval_at(eps) - eval_at(-eps)) / (2.0 * eps)
