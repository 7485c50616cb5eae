"""What a measurement names its device by, and the check that there is one.

Every number a measuring script prints stands beside the card it came from:
JAX's platform, ``device_kind`` and device count, and ``nvidia-smi``'s name
and power limit (a card set below its maximum runs slower under load).
"""

from __future__ import annotations

import subprocess
import typing


def nvidia_smi() -> str:
    """``name, power.limit`` of every card, one line each, from a child
    process that never touches JAX ("unavailable" when it cannot run)."""
    try:
        proc = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f'unavailable ({exc.__class__.__name__})'
    if proc.returncode != 0:
        return f'unavailable (exit {proc.returncode})'
    return proc.stdout.strip()


def require_gpu() -> typing.Dict[str, typing.Any]:
    """The device record ``{platform, kind, count}`` of JAX's first device;
    raises SystemExit when it is not a GPU (a measurement never falls back
    to the CPU)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit(
            f'no GPU: JAX found {dev.platform} ({dev.device_kind}); '
            'this script measures the card and does not fall back'
        )
    return {'platform': dev.platform, 'kind': dev.device_kind,
            'count': len(jax.devices())}
