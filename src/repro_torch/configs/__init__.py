"""Model configurations of the port (port of ``repro.configs``)."""
from repro_torch.configs.base import (ArchConfig, get_config,
                                      get_reduced_config)

__all__ = ["ArchConfig", "get_config", "get_reduced_config"]
