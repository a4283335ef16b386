"""Serving steps of the port (port of ``repro.serve.steps``): the fleet's
N-stream camera step and batched server step, and the LM's prefill,
greedy decode step and greedy loop."""
