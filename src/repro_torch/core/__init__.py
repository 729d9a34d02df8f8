"""Core STORM library of the port: hashes, sketch, DFO and the ERM spine."""
