"""The one place that decides what the backend JAX found means.

* ``cpu``: where the tests run.  No device metric (roofline share,
  bandwidth) is reported.
* ``gpu``: the target (NVIDIA H100).  Nothing falls back to the CPU or
  to a reference.
* anything else: an error.
"""

from __future__ import annotations

import functools
import shutil
import subprocess
from dataclasses import dataclass

import jax

SUPPORTED = ("cpu", "gpu")


@dataclass(frozen=True)
class DeviceInfo:
    platform: str  # jax.devices()[0].platform
    kind: str  # jax.devices()[0].device_kind
    count: int  # len(jax.devices())

    def as_dict(self) -> dict:
        return {"platform": self.platform, "kind": self.kind, "count": self.count}


def device_info() -> DeviceInfo:
    """Platform, device kind and device count of JAX's default backend.

    Raises RuntimeError on a backend this program does not support.
    """
    devs = jax.devices()
    info = DeviceInfo(devs[0].platform, devs[0].device_kind, len(devs))
    if info.platform not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX backend {info.platform!r} "
            f"({info.kind}); supported: {', '.join(SUPPORTED)}"
        )
    return info


@functools.lru_cache(maxsize=None)
def nvidia_smi_line() -> str | None:
    """``name, power.limit`` of the first card as nvidia-smi reports it,
    or None where there is no nvidia-smi (the CPU backend)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
        timeout=30,
    ).stdout
    return out.strip().splitlines()[0] if out.strip() else None


def power_limit() -> str:
    """The card's power limit (e.g. ``700.00 W``), or ``n/a`` off the GPU."""
    line = nvidia_smi_line()
    if line is None:
        return "n/a"
    return line.rsplit(",", 1)[-1].strip()
