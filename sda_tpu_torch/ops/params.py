"""Packed-Shamir parameter generation (copy of ``sda_tpu/ops/params.py``).

Valid parameter sets satisfy ``order(omega_secrets) == k + t + 1 == 2**a``,
``order(omega_shares) == n + 1 == 3**b`` and ``2**a * 3**b | p - 1`` with p
prime. ``find_packed_parameters`` returns the same ``(p, omega_secrets,
omega_shares)`` as the reference for the same seed. ``is_prime`` routes
moduli of at least ``NATIVE_MODEXP_BITS`` bits (Paillier's candidates)
through the native layer's Montgomery modexp, as the reference routes them
through OpenSSL's; field moduli stay on Python's ``pow``, where a ctypes
call would cost more than it saves.
"""

from __future__ import annotations

import math
import random

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]

#: the fixed 12-base Miller-Rabin set is a proven deterministic test only
#: below this bound
_DETERMINISTIC_MR_BOUND = 3317044064679887385961981

#: the modulus size from which ``is_prime`` takes the native modexp
#: (the reference's ``best_mod_exp(min_bits=128)``)
NATIVE_MODEXP_BITS = 128


def is_prime(n: int, rng=None) -> bool:
    """Miller-Rabin: deterministic for n < 3.3e24; above that, 40 extra
    random-base rounds (error < 4^-40)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1

    if n.bit_length() >= NATIVE_MODEXP_BITS:
        from ..native import mod_exp as _pow
    else:
        _pow = pow

    def strong_probable_prime(a: int) -> bool:
        x = _pow(a, d, n)
        if x in (1, n - 1):
            return True
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                return True
        return False

    bases = list(_SMALL_PRIMES)
    if n >= _DETERMINISTIC_MR_BOUND:
        if rng is None:
            import secrets as _secrets

            draw = lambda: _secrets.randbelow(n - 3) + 2  # noqa: E731
        else:
            draw = lambda: rng.randrange(2, n - 1)  # noqa: E731
        bases += [draw() for _ in range(40)]
    return all(strong_probable_prime(a) for a in bases)


def _factorize(n: int) -> dict:
    """Prime factorization (trial division + Pollard rho); fine for 64-bit."""
    factors: dict = {}

    def add(p):
        factors[p] = factors.get(p, 0) + 1

    def rho(n):
        if n % 2 == 0:
            return 2
        while True:
            x = random.randrange(2, n)
            y, c, d = x, random.randrange(1, n), 1
            while d == 1:
                x = (x * x + c) % n
                y = (y * y + c) % n
                y = (y * y + c) % n
                d = math.gcd(abs(x - y), n)
            if d != n:
                return d

    stack = [n]
    while stack:
        m = stack.pop()
        if m == 1:
            continue
        if is_prime(m):
            add(m)
            continue
        for p in _SMALL_PRIMES:
            if m % p == 0:
                add(p)
                stack.append(m // p)
                break
        else:
            d = rho(m)
            stack.extend([d, m // d])
    return factors


def element_order(x: int, p: int) -> int:
    """Multiplicative order of x in F_p*."""
    x = x % p
    if x == 0:
        raise ValueError("0 has no multiplicative order")
    order = p - 1
    for q in _factorize(p - 1):
        while order % q == 0 and pow(x, order // q, p) == 1:
            order //= q
    return order


def _root_of_unity(p: int, n: int, rng: random.Random) -> int:
    """Find an element of exact order n in F_p* (requires n | p-1)."""
    if (p - 1) % n != 0:
        raise ValueError(f"{n} does not divide p-1")
    n_factors = _factorize(n)
    while True:
        g = rng.randrange(2, p)
        omega = pow(g, (p - 1) // n, p)
        if omega == 1:
            continue
        if all(pow(omega, n // q, p) != 1 for q in n_factors):
            return omega


def validate_packed_parameters(scheme) -> None:
    """Raise ValueError unless a PackedShamirSharing scheme is well-formed."""
    m2 = scheme.secret_count + scheme.privacy_threshold + 1
    m3 = scheme.share_count + 1
    p = scheme.prime_modulus
    if m2 & (m2 - 1) != 0:
        raise ValueError(f"secret_count+privacy_threshold+1={m2} must be a power of 2")
    if 3 ** round(math.log(m3, 3)) != m3:
        raise ValueError(f"share_count+1={m3} must be a power of 3")
    if not is_prime(p):
        raise ValueError(f"prime_modulus={p} is not prime")
    if element_order(scheme.omega_secrets, p) != m2:
        raise ValueError(f"omega_secrets must have order {m2}")
    if element_order(scheme.omega_shares, p) != m3:
        raise ValueError(f"omega_shares must have order {m3}")
    if scheme.share_count < scheme.reconstruction_threshold:
        raise ValueError("share_count below reconstruction threshold")


def find_packed_parameters(
    secret_count: int,
    privacy_threshold: int,
    share_count: int,
    min_modulus_bits: int = 24,
    seed: int | None = None,
):
    """Generate ``(prime_modulus, omega_secrets, omega_shares)``: the smallest
    prime ``p >= 2**min_modulus_bits`` with ``m2*m3 | p-1``, then roots of
    unity of exact orders m2, m3 sampled from ``random.Random(seed)``."""
    m2 = secret_count + privacy_threshold + 1
    m3 = share_count + 1
    if m2 & (m2 - 1) != 0:
        raise ValueError(f"secret_count+privacy_threshold+1={m2} must be a power of 2")
    b = round(math.log(m3, 3))
    if 3**b != m3:
        raise ValueError(f"share_count+1={m3} must be a power of 3")
    if min_modulus_bits > 61:
        raise ValueError("moduli >= 2^62 exceed the wide math plane")
    step = m2 * m3
    c = (2**min_modulus_bits) // step + 1
    while not is_prime(c * step + 1):
        c += 1
    p = c * step + 1
    rng = random.Random(seed)
    return p, _root_of_unity(p, m2, rng), _root_of_unity(p, m3, rng)
