"""The ``device`` entry of a result line: the card's name and count, the
peak memory and, beside them, the power limit ``nvidia-smi`` reads
(copied from ``chip_smoke.py::phase_device``): a card set below 700 W runs
slower under load."""

from __future__ import annotations

import subprocess

import torch


def power_limit() -> str:
    """``name, power.limit`` of every card as nvidia-smi prints them, or
    what went wrong."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    if smi.returncode != 0:
        return f"nvidia-smi failed: {smi.stderr.strip()}"
    return "; ".join(line.strip() for line in smi.stdout.splitlines() if line.strip())


def device_entry(device: torch.device, count: int, peak_bytes: int) -> dict:
    entry = {"platform": "cpu", "kind": "cpu", "count": int(count),
             "memory_peak_bytes": int(peak_bytes)}
    if device.type == "cuda":
        entry.update(platform="gpu", kind=torch.cuda.get_device_name(device),
                     power_limit=power_limit())
    return entry
