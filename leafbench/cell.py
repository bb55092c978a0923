"""One cell of BENCHMARK.json as a run sees it, and what the run found."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch


@dataclass
class Cell:
    name: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # limits/<workload>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float             # process start, time.monotonic()
    tmpdir: Optional[str] = None

    @property
    def cfg(self) -> dict:
        return self.config["cfg"]


@dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    ctx: dict                                  # what the metric readers read
    checks: List[Tuple[str, float, float]] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return all(v == v and v <= lim for _, v, lim in self.checks) \
            and bool(self.checks)
