"""Training for the port (the NMT slice): task, optimizer, state, trainer
and the experiment runner."""
