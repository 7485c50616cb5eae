# Developer entry points.
.PHONY: native test smoke bench wheel clean

# Build both native host modules for this machine (keyed under native/.build).
native:
	python -c 'from pysubstringsearch_jax.ops import native; native.require()'

test:
	python -m pytest tests/ -x -q

# End-to-end run on one NVIDIA GPU (exits non-zero without one).
smoke:
	python chip_smoke.py

bench:
	python bench.py

wheel:
	python -m build

clean:
	rm -rf native/.build build dist *.egg-info
