from .exclusive import exclusive_prods, guarded_exclusive_prod_scan
from .syndrome import syndrome_matches, syndrome_of

__all__ = [
    "exclusive_prods",
    "guarded_exclusive_prod_scan",
    "syndrome_of",
    "syndrome_matches",
]
