"""Bitcoin miner on PyTorch and CUDA: sha256d scan kernels for NVIDIA Hopper.

The package mirrors the subpackage layout of ``bitcoin_miner_tpu`` (the JAX
reference) so each module's counterpart is found under the same name. It
imports ``torch`` and never ``jax``, and keeps its own copy of every host
module it needs. Entry points run on the CUDA card unless the caller asks
for ``device="cpu"``, where every kernel's plain PyTorch version runs.
"""
