"""sgc_tpu_torch: the PyTorch/CUDA port of sgc_tpu for NVIDIA Hopper.

A package of its own beside ``sgc_tpu`` (the JAX reference, which it
never imports). Module names mirror the reference so each counterpart is
easy to find (``sgc_tpu_torch/graph/sparse.py`` <-> ``sgc_tpu/graph/
sparse.py``). Hand-written CUDA kernels live in ``csrc/`` and are built
with ``nvcc`` at first use; see ``ops/spmm_blockdense.py`` (kernel A),
``ops/spmm.py`` (kernels B and D) and ``ops/spmm_tiled.py`` (kernel C)
for their wrappers and plain PyTorch versions.

Importing the package starts no build and touches no device.
"""
