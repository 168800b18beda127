from ._inv_quad_logdet import inv_quad_logdet
from ._solve import solve

__all__ = ["inv_quad_logdet", "solve"]
