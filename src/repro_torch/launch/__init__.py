"""Launch entry points of the port (port of ``repro.launch``): the LM
serving launcher, :mod:`repro_torch.launch.serve`. The fleet, training
and mesh launchers wait for their slices (ROADMAP)."""
