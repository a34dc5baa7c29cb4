"""Numerical debugging aids: NaN/Inf trapping and buffer audits.

The reference relies on scrub-and-continue guards (NaN scrubbed before
ACES and OIDN, /root/reference/common.hpp:50-55, camera.hpp:601-606) and
has no detector. The functional JAX build removes data races by
construction (SURVEY §5.2); this module adds the missing *detection*
side: checkify-based NaN traps for debugging runs and a buffer audit
that localizes non-finite values instead of silently scrubbing them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def checked(fn, *, errors=checkify.float_checks):
    """Wrap `fn` with checkify NaN/Inf traps: returns a callable with the
    same signature that RAISES (via err.throw()) on the first non-finite
    intermediate instead of propagating it.

    Debug tool — the checks disable fusion around every float op, so use
    on small repros, not production renders:

        render_dbg = debug.checked(functools.partial(
            integrator.render, config=cfg))
        out = render_dbg(scene, cam, env, key)   # raises on hidden NaNs
    """
    cfn = checkify.checkify(fn, errors=errors)

    def wrapped(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        err.throw()
        return out

    return wrapped


def audit_buffers(buffers: dict, *, name: str = "render") -> dict:
    """Count non-finite values per buffer; returns {buffer: bad_count}.

    Use alongside colorspace.scrub_non_finite: the scrub keeps images
    presentable (reference behavior), the audit tells you the scrub fired
    and where.
    """
    report = {}
    for key, buf in buffers.items():
        arr = jnp.asarray(buf)
        bad = int(jnp.sum(~jnp.isfinite(arr)))
        if bad:
            report[key] = bad
    return report
