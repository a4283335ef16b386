"""LM training of the port (port of ``repro.train``): the chunked
cross-entropy and the train step."""
