from .atomic import CorruptCheckpointError, atomic_replace, sha256_hex

__all__ = ["CorruptCheckpointError", "atomic_replace", "sha256_hex"]
