# Developer entry points. The CPU test suite cannot see device faults or
# GPU numerics: on a machine with a GPU, `make check-gpu` runs the on-card
# check (chip_smoke.py) and the GPU-marked tests.

PY ?= python

.PHONY: test test-fast check-gpu bench bench-tiny install-smoke

test:
	$(PY) -m pytest tests/ -q -n 6 --dist loadfile

# Fast inner loop: skips multiprocess-distributed and inverse-rendering
# fits (marked slow).
test-fast:
	$(PY) -m pytest tests/ -q -m "not slow" -n 6 --dist loadfile

# Packaging smoke (offline): build the wheel, install it into a fresh
# venv (runtime deps resolved from the dev env via PYTHONPATH — this
# image has no network), and import/build a scene with `flax` import
# BLOCKED to prove the core needs only the declared dependencies.
SITE := $(shell $(PY) -c "import site; print(site.getsitepackages()[0])")
install-smoke:
	rm -rf /tmp/rt_venv /tmp/rt_wheel
	$(PY) -m pip -q wheel -w /tmp/rt_wheel --no-deps --no-build-isolation .
	$(PY) -m venv /tmp/rt_venv
	/tmp/rt_venv/bin/pip -q install --no-deps /tmp/rt_wheel/*.whl
	cd /tmp && JAX_PLATFORMS=cpu PYTHONPATH=$(SITE) /tmp/rt_venv/bin/python -c "\
	import sys; \
	sys.modules['flax'] = None; \
	from raytracer_project_tpu.models import presets; \
	s = presets.shirley_final_scene(grid=2, with_bvh=True); \
	print('install-smoke ok:', s.primitive_count, 'prims')"

# On-card check; exits nonzero on any failed phase or without a GPU.
check-gpu:
	timeout 1200 $(PY) chip_smoke.py
	$(PY) -m pytest tests/ -q -m gpu

bench:
	$(PY) bench.py

bench-tiny:
	BENCH_WIDTH=128 BENCH_HEIGHT=72 BENCH_SPP=4 $(PY) bench.py
