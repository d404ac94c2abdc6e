"""Tensor ops of the port: pooling wrappers and the CUDA kernels.

Importing the package registers the kernels' operators (``library``).
"""

from . import library  # noqa: F401
