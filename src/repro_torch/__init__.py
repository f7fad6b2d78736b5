"""CIM-Tuner on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors the reference (``core/``, ``configs/``, ``kernels/``,
``search/``): each module sits at the same relative path as its JAX
counterpart.  The package imports ``torch`` and numpy, never JAX and never
the reference package.  ``convert`` turns reference objects into the
port's, for tests that feed both packages the same inputs.
"""
