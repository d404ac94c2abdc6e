"""Path-parity alias for the reference's pretorched/models/utils.py
(``SizeEstimator`` :5-78, ``Identity`` :81-87)."""

from ..utils.size import SizeEstimator  # noqa: F401
from .layers import Identity  # noqa: F401
