"""The accelerator a measurement runs on: a GPU, named as JAX and
``nvidia-smi`` report it.

bench.py and chip_smoke.py measure the device path and refuse to run
anywhere else: a figure taken on the CPU backend is never reported under a
device metric's name.
"""

from __future__ import annotations

import json
import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def nvidia_smi_line() -> str:
    """First card's ``name, power.limit`` as nvidia-smi prints it.  Runs in
    a child process that does not import JAX."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def parse_nvidia_smi(line: str) -> tuple[str, float]:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> (name, watts)."""
    name, limit = (part.strip() for part in line.rsplit(",", 1))
    if not limit.endswith("W"):
        raise ValueError(f"unexpected power limit in {line!r}")
    return name, float(limit[:-1])


def device_info(devices) -> dict:
    """platform / kind / count of a JAX device list."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def require_gpu() -> dict:
    """:func:`device_info` of the default backend's devices; raises unless
    they are GPUs."""
    import jax
    info = device_info(jax.devices())
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"needs a GPU, JAX found platform {info['platform']!r}")
    return info


def result_line(info: dict) -> str:
    """The closing JSON line of a passing smoke run."""
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})
