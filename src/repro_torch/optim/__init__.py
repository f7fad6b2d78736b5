from repro_torch.optim.adamw import AdamW, AdamWConfig, cosine_schedule
from repro_torch.optim.compression import (
    compressed_allreduce,
    dequantize_int8,
    quantize_int8,
)

__all__ = [
    "AdamW", "AdamWConfig", "cosine_schedule",
    "quantize_int8", "dequantize_int8", "compressed_allreduce",
]
