"""The LM scaffold of the port (port of ``repro.models``): the
decoder-only LMs (dense, MoE, RWKV, hybrid Mamba and VLM) and the
encoder-decoder LM, for serving."""
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM, Stack

__all__ = ["DecoderLM", "EncDecLM", "Stack"]
