"""Fleet serving steps of the port: the N-stream camera step and the
batched server step (port of ``repro.serve.steps``)."""
