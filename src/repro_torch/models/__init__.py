"""The LM scaffold of the port (port of ``repro.models``): the dense and
RWKV decoder-only LMs, for serving."""
from repro_torch.models.transformer import DecoderLM, Stack

__all__ = ["DecoderLM", "Stack"]
