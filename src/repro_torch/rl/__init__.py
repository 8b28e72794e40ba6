"""Deep-RL agents of the control plane (port of ``repro.rl``)."""
