"""The shipped property-test harness (counterpart of linear_operator_tpu/test/).

Part of the package, so that a library defining its own operator inherits the
whole suite: subclass ``LinearOperatorTestCase`` (square PSD) or
``RectangularLinearOperatorTestCase`` and implement ``create_linear_op`` and
``evaluate_linear_op``.  Set ``device`` on the case to run it on a CUDA
device.
"""

from .base_test_case import BaseTestCase
from .linear_operator_test_case import LinearOperatorTestCase, RectangularLinearOperatorTestCase

__all__ = ["BaseTestCase", "LinearOperatorTestCase", "RectangularLinearOperatorTestCase"]
