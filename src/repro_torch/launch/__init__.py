"""Entry points of the port: the paper run, the simulator, sweeps, LM
training and serving, and the launch layer (steps, dry-run, roofline)."""
