"""The seven examples of ``examples/`` on the port (each a module with
``main(argv=None) -> dict``): run one as ``python -m
repro_torch.examples.<name>``; ``--device cpu`` runs it on the CPU, the
default is the card (raising without one)."""
