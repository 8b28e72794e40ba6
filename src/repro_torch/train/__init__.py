"""The optimiser of the control plane's agents (port of ``repro.train``)."""
