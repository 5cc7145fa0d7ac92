"""Shared measurement discipline for the GPU scripts (bench.py,
chip_smoke.py, tools/sweep_march.py).

* They run on a GPU or not at all: `require_gpu` fails elsewhere, so no
  CPU number is ever reported as a device number.
* Every number is printed beside the card's name and power limit
  (`card_info`): a card set below its maximum power runs slower.
* Frame times are host-clock times around work that ends in
  `block_until_ready`: batches of pipelined dispatches, median of >= 3
  batches (`time_batches`). Compilation is timed separately, before.
* They share the CLI's persistent compile cache
  (relativisticraytracer_tpu/compile_cache.py).
"""

from __future__ import annotations

import statistics
import subprocess
import time as _time

from relativisticraytracer_tpu.compile_cache import enable_compile_cache

enable_compile_cache()


def require_gpu():
    """The first JAX device, which must be a GPU; raises SystemExit else."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX's first device is {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return dev


def card_info() -> str:
    """`name, power.limit` of the card(s) as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        raise SystemExit(f"nvidia-smi failed: {e}")
    return out


def time_first_call(fn) -> float:
    """Seconds for the first call of `fn` (compile + one run), synced."""
    t0 = _time.perf_counter()
    fn(0).block_until_ready()
    return _time.perf_counter() - t0


def time_batches(fn, batches: int = 3, per_batch: int = 3):
    """(median ms/frame, [ms/frame per batch]) for `fn(i)` -> device array.

    Each batch dispatches `per_batch` calls back to back and blocks on all
    of them, so dispatch overlaps execution as in an animation job."""
    import jax

    per = []
    k = 0
    for _ in range(batches):
        t0 = _time.perf_counter()
        outs = []
        for _ in range(per_batch):
            outs.append(fn(k))
            k += 1
        jax.block_until_ready(outs)
        per.append((_time.perf_counter() - t0) * 1000.0 / per_batch)
    return statistics.median(per), per


def lowers_to_triton(jitted, *args) -> bool:
    """True if `jitted(*args)` lowers to a compiled Triton kernel call
    (and so does not run the Pallas interpreter)."""
    return "__gpu$xla.gpu.triton" in jitted.lower(*args).as_text()
