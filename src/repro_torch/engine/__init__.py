"""Serving engines of the port: the single-stream chunk loop with its QP
policies, and the N-stream fleet engine."""
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.engine import (ChunkContext, StreamingEngine,
                                       jit_encode)
from repro_torch.engine.multistream import FleetResult, MultiStreamEngine
from repro_torch.engine.policies import (AccMPEGPolicy, QPPolicy,
                                         UniformPolicy, warm_ready)

__all__ = ["AccMPEGPolicy", "ChunkContext", "EngineConfig", "FleetResult",
           "MultiStreamEngine", "QPPolicy", "StreamingEngine",
           "UniformPolicy", "jit_encode", "warm_ready"]
