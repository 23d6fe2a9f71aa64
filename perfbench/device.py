"""The few device calls the harness makes, so that a run's logic also runs
on the CPU in the tests (where they do nothing)."""

from __future__ import annotations

import gc

import torch

__all__ = ["sync", "reset_peak", "peak_bytes", "release", "Timer"]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0


def release(device) -> None:
    """Drop what nothing refers to any more and return the cached blocks."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Timer:
    """CUDA events around calls on the current stream; ``ms()`` waits and
    returns each call's device milliseconds. A no-op off the card."""

    def __init__(self, device):
        self.on = torch.device(device).type == "cuda"
        self.pairs = []

    def start(self):
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs.append([ev, None])

    def stop(self):
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs[-1][1] = ev

    def ms(self):
        if not self.pairs:
            return []
        self.pairs[-1][1].synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]
