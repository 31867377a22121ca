"""Small shared helpers (port of relativisticraytracer_tpu.core.utils)."""


def largest_divisor_at_most(n: int, k: int) -> int:
    """The largest divisor of n that is <= k (>= 1)."""
    k = max(1, min(k, n))
    for c in range(k, 0, -1):
        if n % c == 0:
            return c
    return 1
