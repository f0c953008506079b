"""The port's examples (examples_torch/) on the CPU: each of the five
scripts, in a subprocess with FHE_EXAMPLE_DEVICE=cpu at the degrees
tests/test_examples.py gives the JAX package's examples (1024;
bgv_operations.py 512, bootstrapping.py 128), checks its expected vectors
and exits 0.  The scripts import only fhe_tpu_torch, numpy and torch."""

import os
import pathlib
import subprocess
import sys

import pytest

_EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples_torch"


@pytest.mark.parametrize("script", [
    "basic_encryption.py",
    "homomorphic_operations.py",
    "batch_processing.py",
    "bgv_operations.py",
    "bootstrapping.py",
])
def test_port_example_exits_zero(script):
    env = dict(os.environ)
    env["FHE_EXAMPLE_DEVICE"] = "cpu"
    small = {"bootstrapping.py": "128", "bgv_operations.py": "512"}
    env["FHE_EXAMPLE_POLY_DEGREE"] = small.get(script, "1024")
    proc = subprocess.run([sys.executable, str(_EXAMPLES / script)],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, (
        f"{script} failed\nstdout:\n{proc.stdout[-3000:]}\nstderr:\n{proc.stderr[-3000:]}")


def test_port_example_refuses_a_missing_card():
    """The default device is the card, with no fallback: without one the
    script raises and exits non-zero."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if k != "FHE_EXAMPLE_DEVICE"}
    env["FHE_EXAMPLE_POLY_DEGREE"] = "1024"
    proc = subprocess.run([sys.executable, str(_EXAMPLES / "basic_encryption.py")],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
