# The LM's serve path: the decoder architectures as PyTorch modules.
from .transformer import LM, init_params  # noqa: F401
