from .codec import canonical_dumps, canonical_loads, b64e, b64d

__all__ = [
    "canonical_dumps",
    "canonical_loads",
    "b64e",
    "b64d",
]
