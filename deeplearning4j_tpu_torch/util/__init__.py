from .platform import resolve_device, strict_fp32
from .serializer import ModelGuesser, ModelSerializer, from_jax_params

__all__ = ["resolve_device", "strict_fp32", "ModelGuesser",
           "ModelSerializer", "from_jax_params"]
