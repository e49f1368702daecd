"""Kernels of the dense data plane and their plain PyTorch versions."""

from .fused_update import adam_update, sgd_update
from .quantize import dequantize_int8, quantize_int8

__all__ = ["adam_update", "sgd_update", "quantize_int8", "dequantize_int8"]
