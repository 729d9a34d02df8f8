"""Architecture configurations and the registry (port of ``repro.configs``)."""
