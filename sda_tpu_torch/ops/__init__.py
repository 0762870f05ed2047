from .params import (
    element_order,
    find_packed_parameters,
    is_prime,
    validate_packed_parameters,
)
from .shamir import verify_scheme

__all__ = [
    "element_order",
    "find_packed_parameters",
    "is_prime",
    "validate_packed_parameters",
    "verify_scheme",
]
