"""PyTorch/CUDA port of the ``repro`` model stack for NVIDIA Hopper.

A second package beside the JAX one, with the same layout and names
(``configs``, ``models``, ``kernels/<name>``, ``distributed``, ``launch``).
It imports ``torch`` and never ``jax``, and nothing of ``repro``. Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""
