"""Runtime planes of the port: config and telemetry."""
