"""What every measurement in this repository shares: a GPU or nothing, the
device it ran on, the card's name and power limit, one timer, and seeded
related sequence pairs."""
from __future__ import annotations

import subprocess
import time

import numpy as np


class NoGPU(RuntimeError):
    """JAX's default devices are not the GPU(s) a measurement needs."""


def gpu_devices(count: int | None = None):
    """JAX's devices, which must be GPUs (``count`` of them if given)."""
    import jax

    dev = jax.devices()
    if dev[0].platform != "gpu":
        raise NoGPU(f"no GPU: JAX found {dev[0].platform}")
    if count is not None and len(dev) != count:
        raise NoGPU(f"expected {count} GPU(s), JAX found {len(dev)}")
    return dev


def device_record(dev) -> dict:
    return {"platform": dev[0].platform, "kind": dev[0].device_kind,
            "count": len(dev)}


def card_line() -> str:
    """``name, power.limit`` of the first card, read by a child process
    that stays off JAX (the parent holds the card)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 3):
    """Warm up once, then time ``reps`` calls, each ended with
    ``block_until_ready``. Returns (median seconds, reps, last result)."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), reps, out


def related_pair(rng, n: int, sub_rate: float = 0.05):
    """A seeded length-n ACGT sequence and a copy with ~sub_rate
    substitutions."""
    alpha = np.frombuffer(b"ACGT", np.uint8)
    q = alpha[rng.integers(0, 4, n)]
    s = q.copy()
    hit = rng.random(n) < sub_rate
    s[hit] = alpha[rng.integers(0, 4, int(hit.sum()))]
    return bytes(q), bytes(s)
