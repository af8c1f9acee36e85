"""The card: its presence, name, power limit and memory peak."""

from __future__ import annotations

import subprocess
import sys

import torch


class NoCard(RuntimeError):
    pass


def require_cards(count: int) -> None:
    """Raise :class:`NoCard` unless ``count`` CUDA cards are visible: a run
    never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card is visible")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell needs {count} cards, {torch.cuda.device_count()} visible")


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def info(device: torch.device, count: int, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak_bytes}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": count,
        "memory_peak_bytes": peak_bytes,
    }


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def note(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
