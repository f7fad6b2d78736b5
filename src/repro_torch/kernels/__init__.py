"""Hand-written Hopper kernels of the port, their wrappers and their plain
PyTorch versions.

* ``strategy_eval`` -- the DSE hot loop (candidates x operators x 8
  strategies), ``csrc/strategy_eval.cu``;
* ``cim_matmul`` -- the paper's AF / PF macro tiling as a blocked matmul,
  ``csrc/cim_matmul.cu``;
* ``flash_attention`` -- streaming-softmax attention,
  ``csrc/flash_attention.cu``;
* ``selective_scan`` -- the Mamba-1 recurrence, ``csrc/selective_scan.cu``.

Each is CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use by
``build.py`` and bound with ``ctypes`` (one module per kernel).
``ops.py`` holds the wrappers (plain version on CPU tensors, the kernel on
CUDA tensors), ``ref.py`` the plain versions.
"""
