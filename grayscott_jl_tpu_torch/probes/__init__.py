"""Measurement probes of the port's kernels on the card
(``envelope_probe``: the stencil chain's copy and compute envelopes,
counterpart of ``benchmarks/envelope_probe.py``)."""
