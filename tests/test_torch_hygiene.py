"""fhe_tpu_torch and chip_smoke.py stand apart from JAX and from fhe_tpu:
importing the package loads neither, and no source of theirs imports them."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|fhe_tpu)\b|from\s+(jax|flax|fhe_tpu)\b"
    r"|from\s+\.\.+\s+import\s+fhe_tpu\b)", re.M)


def test_import_leaves_jax_and_fhe_tpu_unloaded():
    code = ("import sys, fhe_tpu_torch, fhe_tpu_torch.convert, "
            "fhe_tpu_torch.ops.decrypt_cuda, fhe_tpu_torch.ops.rns_cuda, "
            "fhe_tpu_torch.ops.galois_cuda, fhe_tpu_torch.utils.ubench, "
            "fhe_tpu_torch.scheme.bgv\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'fhe_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax_or_fhe_tpu():
    files = sorted((ROOT / "fhe_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
