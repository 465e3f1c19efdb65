from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm  # noqa: F401
from .compression import CompressionState, compression_init, ef_int8_compress  # noqa: F401
from .schedule import warmup_cosine  # noqa: F401
