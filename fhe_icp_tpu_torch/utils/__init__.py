"""Utilities of the port: quantization contracts."""

from .quantize import (DEFAULT_SCALE, SymmetricQuantizer, dequantize_score,
                       prepare_embedding_for_fhe)

__all__ = ["DEFAULT_SCALE", "SymmetricQuantizer", "dequantize_score",
           "prepare_embedding_for_fhe"]
