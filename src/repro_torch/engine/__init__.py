"""Serving engines of the port: the single-stream chunk loop with the QP
policies of the paper's comparison, and the N-stream fleet engine."""
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.engine import ChunkContext, StreamingEngine, jit_encode
from repro_torch.engine.multistream import FleetResult, MultiStreamEngine
from repro_torch.engine.policies import (AccMPEGPolicy, DDSPolicy, EAARPolicy,
                                         QPPolicy, ReductoAccMPEGPolicy,
                                         ReductoPolicy, SiEVEPolicy,
                                         UniformPolicy, VigilPolicy,
                                         boxes_to_mask, class_presence,
                                         frame_diff_feature,
                                         soft_drop_previous)

__all__ = [
    "AccMPEGPolicy", "ChunkContext", "DDSPolicy", "EAARPolicy",
    "EngineConfig",
    "FleetResult", "MultiStreamEngine", "QPPolicy", "ReductoAccMPEGPolicy",
    "ReductoPolicy", "SiEVEPolicy", "StreamingEngine", "UniformPolicy",
    "VigilPolicy", "boxes_to_mask", "class_presence", "frame_diff_feature",
    "jit_encode", "soft_drop_previous",
]
