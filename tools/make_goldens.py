#!/usr/bin/env python
"""Regenerate the golden regression images under tests/goldens/.

Run on the CPU backend so goldens are hardware-independent:
    JAX_PLATFORMS=cpu python tools/make_goldens.py
Only regenerate after an INTENTIONAL rendering change, and eyeball the PNGs.
"""

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

# Goldens MUST come from the CPU backend to stay hardware-independent; the
# config flag also wins over any installed accelerator backend.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from relativisticraytracer_tpu.io.image import save_png  # noqa: E402
from tools.golden_cases import CASES, GOLDEN_DIR, render_case  # noqa: E402


def main(only=None):
    GOLDEN_DIR.mkdir(parents=True, exist_ok=True)
    for case in CASES:
        name, _, _, (w, h), *_ = case
        if only and name not in only:
            continue
        img = render_case(case, loop="while")
        np.save(GOLDEN_DIR / f"{name}.npy", img)
        # nearest-neighbour preview for eyeballing
        scale = 256 // max(w, h) + 1 if max(w, h) < 256 else 1
        save_png(str(GOLDEN_DIR / f"{name}.png"),
                 img.repeat(scale, axis=0).repeat(scale, axis=1))
        print(f"golden {name} ({w}x{h}): mean rgb {img[..., :3].mean():.2f}")


if __name__ == "__main__":
    main(only=set(sys.argv[1:]) or None)
