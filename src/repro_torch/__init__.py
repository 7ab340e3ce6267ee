"""PyTorch/CUDA port of the RAPID reproduction (``repro``), for Hopper GPUs.

The package mirrors ``repro``'s module names so each port has an obvious
counterpart.  It imports ``torch`` and numpy only: nothing of JAX and
nothing of ``repro`` (it keeps its own copies of what it needs).  Every
entry point takes a ``device`` argument that defaults to ``"cuda"``; the
attention kernels are CUDA C++ written for ``sm_90a`` (``csrc/``), built at
first use, and a CPU tensor is served by their plain PyTorch versions.
"""
