"""The share of the traced window's device-idle time that the host spent
inside the telemetry bridge's ``bridge.flush`` spans (the program's own
tracer), in %, as ``idle_in_gateway.ingest`` reads the gateway's."""

from h100_bench import harness


def read(run):
    return harness.reader_of("idle_in_gateway.ingest").idle_share(
        run, "bridge.flush")
