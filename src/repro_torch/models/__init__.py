"""The LM stack's serving half (port of ``repro.models``): configuration,
layers, attention and the dense model."""
