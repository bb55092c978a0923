"""The card's name, count and power limit (a frozen copy of
``leaf_tpu_torch.scripts._measure.smi_line`` / ``card``)."""

from __future__ import annotations

import subprocess
from typing import Optional

import torch


def smi_line() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def card(device: torch.device) -> dict:
    """{"kind": the card's name, "power_limit": nvidia-smi's power limit
    or None, "count": torch.cuda.device_count()}; "cpu" on the CPU."""
    if device.type != "cuda":
        return {"kind": "cpu", "power_limit": None, "count": 0}
    line = smi_line()
    return {"kind": torch.cuda.get_device_name(device),
            "power_limit": line.split(",")[-1].strip() if line else None,
            "count": torch.cuda.device_count()}
