from .params import find_packed_parameters, is_prime
from .shamir import verify_scheme

__all__ = ["find_packed_parameters", "is_prime", "verify_scheme"]
