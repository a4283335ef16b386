"""Launch entry points of the port (port of ``repro.launch``): the LM
serving launcher (:mod:`~repro_torch.launch.serve`), the LM training
driver (:mod:`~repro_torch.launch.train`) and the dry-run of the
workload cells on one card (:mod:`~repro_torch.launch.dryrun`, with
:mod:`~repro_torch.launch.specs`, :mod:`~repro_torch.launch.analysis`
and :mod:`~repro_torch.launch.contrib`). The fleet and mesh launchers
wait for the multi-GPU slice (ROADMAP module 8)."""
