"""Number-theory helpers for FFT planning.

TPU-native rebuild of the planning math in the reference library
(reference: src/utils/factors.js:1-115).  The *set* of supported radices and
the axis-kind policy mirror the reference; the implementation is new and
extended for the matmul-based TPU engine (sub-length grouping instead of
per-radix butterfly stages).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional

# Radix set the reference supports for its Stockham stages
# (reference: src/utils/factors.js:1).  Our TPU engine composes these into
# MXU-sized sub-DFT lengths, so any product of these primes is "smooth".
SUPPORTED_RADICES = (2, 3, 4, 5, 7, 8, 11, 13)
_SMOOTH_PRIMES = (2, 3, 5, 7, 11, 13)


def factorize_supported_radices(n: int) -> Optional[List[int]]:
    """Greedy factorization over the supported radix set, largest first.

    Returns None when ``n`` has a prime factor outside {2,3,5,7,11,13}
    (reference behavior: src/utils/factors.js:3-15).
    """
    if not isinstance(n, int) or n <= 0:
        raise ValueError(f"factorize_supported_radices: n must be positive int, got {n}")
    out: List[int] = []
    x = n
    for r in (13, 11, 8, 7, 5, 4, 3, 2):
        while x % r == 0:
            out.append(r)
            x //= r
    return out if x == 1 else None


def is_smooth(n: int) -> bool:
    """True when n factors completely over {2,3,5,7,11,13}."""
    if n <= 0:
        return False
    x = n
    for p in _SMOOTH_PRIMES:
        while x % p == 0:
            x //= p
    return x == 1


def prime_factors(n: int) -> List[int]:
    """Distinct prime factors of n, ascending."""
    out: List[int] = []
    x = n
    d = 2
    while d * d <= x:
        if x % d == 0:
            out.append(d)
            while x % d == 0:
                x //= d
        d += 1 if d == 2 else 2
    if x > 1:
        out.append(x)
    return out


def prime_factorization(n: int) -> List[int]:
    """Full prime factorization with multiplicity, ascending."""
    out: List[int] = []
    x = n
    d = 2
    while d * d <= x:
        while x % d == 0:
            out.append(d)
            x //= d
        d += 1 if d == 2 else 2
    if x > 1:
        out.append(x)
    return out


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    d = 3
    while d * d <= n:
        if n % d == 0:
            return False
        d += 2
    return True


def mod_pow(base: int, exp: int, mod: int) -> int:
    return pow(base, exp, mod)


def primitive_root_prime(p: int) -> int:
    """Smallest primitive root modulo prime p (used by the Rader path)."""
    if not is_prime(p):
        raise ValueError(f"primitive_root_prime: p must be prime, got {p}")
    phi = p - 1
    factors = prime_factors(phi)
    for g in range(2, p):
        if all(pow(g, phi // q, p) != 1 for q in factors):
            return g
    raise ValueError(f"primitive_root_prime: failed for p={p}")


@lru_cache(maxsize=4096)
def next_smooth_at_least(min_n: int) -> int:
    """Smallest n >= min_n that is {2,3,5,7,11,13}-smooth.

    Used to pick Bluestein work lengths (reference: src/utils/factors.js:79-100
    uses the same "next smooth else next pow2" policy; we never need the pow2
    fallback because the smooth search always terminates quickly).
    """
    if min_n <= 0:
        raise ValueError(f"next_smooth_at_least: min_n must be positive, got {min_n}")
    n = min_n
    while not is_smooth(n):
        n += 1
    return n


def next_pow2(n: int) -> int:
    if n <= 0:
        raise ValueError(f"next_pow2: n must be positive, got {n}")
    return 1 << (n - 1).bit_length()


def split_two_balanced(n: int, max_factor: int) -> Optional[tuple]:
    """Split smooth n into (n1, n2), n1*n2 == n, both <= max_factor, as
    balanced as possible.  Returns None when impossible.

    This drives the fused two-stage VMEM kernel: both sub-DFT matrices must be
    MXU-friendly.  (The reference's analogous balanced split is the axis-0
    two-step chooser, src/plan.js:89-112 — ours optimizes for MXU tile shape
    rather than a storage-binding limit.)
    """
    if n <= 1:
        return None
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0:
            for a in (d, n // d):
                b = n // a
                if a <= max_factor and b <= max_factor and is_smooth(a) and is_smooth(b) and a > 1 and b > 1:
                    key = abs(a - b)
                    if best is None or key < best[0]:
                        best = (key, (a, b))
        d += 1
    return best[1] if best else None


def split_sublengths(n: int, max_sub: int = 32) -> List[int]:
    """Greedy grouping of the prime factorization of smooth n into sub-lengths
    each <= max(max_sub, largest prime factor).

    The TPU engine performs one batched matmul contraction per sub-length, so
    fewer/larger groups = fewer passes but more MACs (cost ~ 4*N*sum(subs)).
    Groups are built largest-prime-first to keep them balanced.
    """
    fac = sorted(prime_factorization(n), reverse=True)
    if not fac:
        return [1]
    cap = max(max_sub, fac[0])
    subs: List[int] = []
    cur = 1
    for p in fac:
        if cur * p <= cap:
            cur *= p
        else:
            subs.append(cur)
            cur = p
    subs.append(cur)
    return subs


def prod(xs) -> int:
    return math.prod(xs)
