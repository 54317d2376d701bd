from .gallager import parity_check_matrix
from .graph import TannerGraph

__all__ = ["parity_check_matrix", "TannerGraph"]
