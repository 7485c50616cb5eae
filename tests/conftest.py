"""Test harness config: run everything on a virtual 8-device CPU mesh so
multi-device sharding paths are exercised without accelerator hardware.

The platform is switched in-process through ``jax.config`` before any
backend is instantiated.  ``PSS_TEST_GPU=1`` leaves JAX on its default
platform instead, for the ``gpu``-marked tests on a card.
"""

import os

_flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (
        _flags + ' --xla_force_host_platform_device_count=8'
    ).strip()

import jax  # noqa: E402

if os.environ.get('PSS_TEST_GPU') != '1':
    jax.config.update('jax_platforms', 'cpu')
