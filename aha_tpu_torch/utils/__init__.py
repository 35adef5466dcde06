"""Host utilities of the port: the runtime telemetry of ``demo`` and ``infer``."""
