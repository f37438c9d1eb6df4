"""FedEPM core on PyTorch: the round, participation, DP noise, tasks and
tree helpers."""
