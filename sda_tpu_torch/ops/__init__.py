from .params import find_packed_parameters, is_prime

__all__ = ["find_packed_parameters", "is_prime"]
