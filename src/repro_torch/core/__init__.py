"""Host-side core of the port: channel models, hints, telemetry, the
duplex offload planner and the admission policies."""
