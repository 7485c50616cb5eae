"""Build glue: ships the native host kernels' sources inside the package.

The reference's equivalent layer is `build.rs` (cc-crate compile of its C
kernel, reference build.rs:4-10) + maturin packaging (reference
pyproject.toml:1-11).  Here `native/sais.cpp` and `native/fastext.c` are
copied into `pysubstringsearch_jax/_native/`; the loader
(`pysubstringsearch_jax/ops/native.py`) compiles them on first use on the
machine that loads them, keyed by source, command and CPU flags, so a wheel
never carries a library built for another CPU.  Without a compiler the
numpy / JAX backends take over.
"""

import os

from setuptools import setup
from setuptools.command.build_py import build_py

HERE = os.path.dirname(os.path.abspath(__file__))


class BuildPyWithNative(build_py):
    def run(self):
        super().run()
        dest_dir = os.path.join(
            self.build_lib, 'pysubstringsearch_jax', '_native'
        )
        os.makedirs(dest_dir, exist_ok=True)
        for name in ('sais.cpp', 'fastext.c'):
            self.copy_file(os.path.join(HERE, 'native', name),
                           os.path.join(dest_dir, name))


setup(cmdclass={'build_py': BuildPyWithNative})
