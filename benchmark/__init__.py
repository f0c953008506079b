"""The benchmark of fhe_tpu_torch on an NVIDIA H100: ``run.py`` runs one cell."""
