"""The paper's baselines (§6.1) as ``run_*`` entry points over the port's
``StreamingEngine``."""
from repro_torch.baselines.baselines import (boxes_to_mask,
                                             frame_diff_feature, run_dds,
                                             run_eaar, run_reducto,
                                             run_uniform, run_vigil)

__all__ = ["boxes_to_mask", "frame_diff_feature", "run_dds", "run_eaar",
           "run_reducto", "run_uniform", "run_vigil"]
