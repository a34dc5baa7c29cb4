"""Where the persistent XLA compilation cache goes (raytracer_project_tpu
package import): JAX_COMPILATION_CACHE_DIR when it is set, and otherwise a
fixed directory inside the checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [True, False])
def test_compilation_cache_dir(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    code = ("import jax, raytracer_project_tpu as r; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(r.compilation_cache_dir())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")
    if env_dir:
        assert out[0] == str(tmp_path)      # JAX's own reading of the env
        assert out[1] == "None"             # the package sets nothing
    else:
        assert out[0] == out[1] == os.path.join(REPO, ".jax_cache")
