"""Number <-> string codec used inside camera view tokens.

The port's own copy of view_neti_tpu/utils/codec.py.
"""
from __future__ import annotations


def num_to_string(num: float, tol: int = 2) -> str:
    """Render a number compactly for embedding in a token string.

    Integers render without a decimal part; non-integers render with `tol`
    decimal places and '.' replaced by 'p' (token strings cannot contain '.').
    """
    if (int(num) - num) == 0:
        return str(int(num))
    return f"{num:.{tol}f}".replace(".", "p")


def string_to_num(s: str) -> float:
    """Inverse of num_to_string."""
    return float(s.replace("p", "."))
