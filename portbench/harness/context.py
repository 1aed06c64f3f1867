"""What the module of a traffic kind is handed (RunContext) and hands back
(Outcome)."""

import dataclasses
import subprocess
import sys
from typing import Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "neural_jacobian_field_tpu")


@dataclasses.dataclass
class Outcome:
    setup_s: float
    attempted: int
    failed: int
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    context: Dict[str, object] = dataclasses.field(default_factory=dict)  # for the readers
    trace: Optional[object] = None  # harness.trace.Trace of the traced sub-window
    memory_peak_bytes: int = 0
    checks: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RunContext:
    cell: object  # harness.cells.Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t0: float  # the process's start on the host clock
    profile: Callable = None  # harness.trace.profile


def card_line(count: int) -> str:
    """The card's name and power limit from nvidia-smi, and the devices used."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    first = out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else "nvidia-smi unreadable"
    return f"{first}, {count} device(s)"


def loaded_forbidden() -> List[str]:
    """Modules of JAX, Flax or the JAX package in this process, compared by
    their whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
