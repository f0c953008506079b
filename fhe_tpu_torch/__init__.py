"""PyTorch / CUDA port of ``fhe_tpu`` for NVIDIA Hopper (H100).

Same module names as ``fhe_tpu``; residues are int32 tensors in the same
prime-major layout.  Every Pallas kernel on a ported path becomes a
hand-written CUDA kernel (``csrc/``, built on first use by ``ops/_build.py``)
with a plain PyTorch twin used for CPU tensors.  This package never imports
JAX or ``fhe_tpu``.
"""

from .api import FHE
from .params import SchemeParams, SecurityParams, make_scheme_params

__all__ = ["FHE", "SchemeParams", "SecurityParams", "make_scheme_params"]
