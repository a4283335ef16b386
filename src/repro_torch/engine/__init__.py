"""Serving engine of the port: the single-stream chunk loop and its QP
policies."""
from repro_torch.engine.engine import (ChunkContext, StreamingEngine,
                                       jit_encode)
from repro_torch.engine.policies import (AccMPEGPolicy, QPPolicy,
                                         UniformPolicy, warm_ready)

__all__ = ["AccMPEGPolicy", "ChunkContext", "QPPolicy", "StreamingEngine",
           "UniformPolicy", "jit_encode", "warm_ready"]
