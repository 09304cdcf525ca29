from .platform import resolve_device, strict_fp32
from .serializer import ModelSerializer, from_jax_params

__all__ = ["resolve_device", "strict_fp32", "ModelSerializer",
           "from_jax_params"]
