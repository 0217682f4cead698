"""The device a measurement runs on.

Benchmarks and the chip smoke test time the GPU and nothing else: they call
`require_gpu()` first, which fails when JAX found no GPU, and they print
`device_info()` beside every number. The card's name and power limit come
from `nvidia-smi`, run as a child process that does not touch JAX.
"""

from __future__ import annotations

import subprocess

import jax

NVIDIA_SMI_QUERY = (
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
)


class NoGpuError(RuntimeError):
    """JAX's default backend has no GPU."""


def require_gpu():
    """The first device, which must be a GPU; raises NoGpuError otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGpuError(
            f"needs an NVIDIA GPU, but JAX runs on {dev.platform} "
            f"({dev.device_kind}); timings on another device are not "
            "measurements of this program"
        )
    return dev


def nvidia_smi() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` as
    printed, one line per card."""
    out = subprocess.run(
        NVIDIA_SMI_QUERY, capture_output=True, text=True, check=True,
        timeout=60,
    )
    return out.stdout.strip()


def parse_nvidia_smi(text: str) -> list[dict]:
    """Lines like 'NVIDIA H200, 700.00 W' -> [{"name", "power_limit_w"}].
    A limit nvidia-smi cannot read ('[N/A]') parses as None."""
    cards = []
    for line in text.strip().splitlines():
        name, _, limit = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        value = limit.strip().removesuffix("W").strip()
        try:
            watts = float(value)
        except ValueError:
            watts = None
        cards.append({"name": name.strip(), "power_limit_w": watts})
    return cards


def device_info(smi_text: str) -> dict:
    """What JAX reports of its devices, with the first card's name and
    power limit from `smi_text` (the output of `nvidia_smi()`)."""
    dev = jax.devices()[0]
    card = parse_nvidia_smi(smi_text)[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": card["name"],
        "power_limit_w": card["power_limit_w"],
    }
