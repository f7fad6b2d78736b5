"""Hand-written Hopper kernels of the port, their wrappers and their plain
PyTorch versions.

* ``strategy_eval`` -- the DSE hot loop (candidates x operators x 8
  strategies) as a CUDA kernel (``csrc/strategy_eval.cu``), built with
  ``nvcc`` at first use and bound with ``ctypes`` (``strategy_eval.py``).

``ops.py`` holds the wrappers (plain version on CPU tensors, the kernel on
CUDA tensors), ``ref.py`` the plain versions.
"""
