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
            "fhe_tpu_torch.scheme.bgv, fhe_tpu_torch.parallel, "
            "fhe_tpu_torch.parallel.launch\n"
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


# -- parity: every public function and class of fhe_tpu has a port ----------

# fhe_tpu modules whose port has another name: the Pallas kernel modules'
# counterparts are the CUDA kernel wrappers
PORT_MODULE = {"ntt_pallas": "ntt_cuda", "rns_pallas": "rns_cuda",
               "galois_pallas": "galois_cuda", "decrypt_pallas": "decrypt_cuda"}
# TPU-only code that is not ported (ROADMAP.md, "Do not port"): the Pallas
# table variants (the port keeps compact twiddles) and the use_pallas knob
# (the port's counterpart is device=)
TPU_ONLY = {"fhe_tpu.ops.ntt_pallas": {"PallasNTTTables", "build_pallas_tables",
                                       "from_tables", "slice_tables", "slice_tables_last"}}
TPU_ONLY_KEYWORDS = {"use_pallas"}
# oracle.py is the arbitrary-precision ground truth both packages' tests
# share, not a part of either library to port; every other module is ported
NOT_PORTED = ("fhe_tpu.oracle",)


def _public(mod) -> set:
    import inspect
    return {k for k, v in vars(mod).items()
            if not k.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == mod.__name__}


def test_every_public_name_of_fhe_tpu_is_ported():
    """For every module of fhe_tpu (its port: the same path in
    fhe_tpu_torch, the Pallas modules' the *_cuda wrappers), each public
    function and class defined there exists in the port's module, but for
    the TPU-only names; and make_context and FHE take every keyword of
    theirs but use_pallas.  oracle.py is the listed exception."""
    import importlib
    import inspect
    import pkgutil

    import fhe_tpu

    missing, checked = {}, 0
    for info in pkgutil.walk_packages(fhe_tpu.__path__, "fhe_tpu."):
        name = info.name
        if name.startswith(NOT_PORTED):
            continue
        parts = name.split(".")[1:]
        parts[-1] = PORT_MODULE.get(parts[-1], parts[-1])
        port = importlib.import_module(".".join(["fhe_tpu_torch"] + parts))
        gap = _public(importlib.import_module(name)) - TPU_ONLY.get(name, set())
        gap = sorted(k for k in gap if not hasattr(port, k))
        checked += 1
        if gap:
            missing[name] = gap
    assert checked >= 25 and not missing, missing
    from fhe_tpu import api as japi
    from fhe_tpu.scheme import context as jcontext

    from fhe_tpu_torch import api as tapi
    from fhe_tpu_torch.scheme import context as tcontext
    for jfn, tfn in ((jcontext.make_context, tcontext.make_context),
                     (japi.FHE.__init__, tapi.FHE.__init__)):
        keys = set(inspect.signature(jfn).parameters) - TPU_ONLY_KEYWORDS
        assert keys <= set(inspect.signature(tfn).parameters), jfn.__qualname__


def test_examples_and_fuzzer_import_no_jax_or_fhe_tpu():
    files = sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "scripts" / "fuzz_torch.py"]
    assert len(files) == 6
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
