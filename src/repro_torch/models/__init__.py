"""The LM architectures of the port: configs, layers, the dense family and
the registry; the counterpart of ``repro.models``."""
