"""The host<->device link as the Reader's routing sees it, measured once.

The Reader decides per batch whether extraction reads hit positions back
from the device or re-probes on the host, and whether a tiny batch is worth
a device round trip at all (api.Reader).  Both decisions weigh host CPU
time against two properties of the link, taken here from the running
process instead of a table: bandwidth each way, and the round trip of a
tiny jitted program with its readback.
"""

from __future__ import annotations

import threading
import time
import typing

import numpy as np


class Link(typing.NamedTuple):
    h2d_mbps: float  # host -> device, MB/s
    d2h_mbps: float  # device -> host, MB/s
    rtt_s: float  # dispatch + readback of a tiny program, seconds


_LINK: typing.Optional[Link] = None
_LOCK = threading.Lock()

#: Transfer size for the bandwidth probes: large enough that a local PCIe
#: or NVLink-C2C transfer is not all latency, small next to device memory.
_PROBE_BYTES = 64 << 20


def host_device_link() -> Link:
    """The measured link, once per process (best of three each).  CPU
    backends report an infinitely fast link with no round trip: the
    "device" is host memory, and the tests keep exercising device routes."""
    global _LINK
    with _LOCK:
        if _LINK is None:
            _LINK = _measure()
        return _LINK


def _measure() -> Link:
    import jax

    if jax.default_backend() == 'cpu':
        return Link(float('inf'), float('inf'), 0.0)
    host = np.ones(_PROBE_BYTES, dtype=np.uint8)
    tiny = jax.jit(lambda x: x + 1)
    np.asarray(tiny(jax.device_put(np.zeros(8, np.int32))))  # compile
    up, down, rtt = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        d = jax.device_put(host)
        d.block_until_ready()
        up.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.asarray(d)
        down.append(time.perf_counter() - t0)
        del d
        x = jax.device_put(np.zeros(8, np.int32))
        x.block_until_ready()
        t0 = time.perf_counter()
        np.asarray(tiny(x))
        rtt.append(time.perf_counter() - t0)
    mb = _PROBE_BYTES / 1e6
    return Link(mb / min(up), mb / min(down), min(rtt))
