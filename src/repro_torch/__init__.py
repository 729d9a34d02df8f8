"""PyTorch/CUDA port of the STORM reproduction (``src/repro``).

The package mirrors ``repro``'s module layout and public names, runs on an
NVIDIA GPU by default, and replaces each Pallas TPU kernel on its path with a
CUDA C++ kernel written for Hopper (``repro_torch.kernels``). It imports
``torch`` and ``numpy`` only: never ``jax`` and never the ``repro`` package.
Weights and state cross between the two packages as numpy arrays through
:mod:`repro_torch.interop`.
"""
