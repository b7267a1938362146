"""Telemetry of the port: so far only the span seam (``spans``); the
recorder, the flight recorder and the program observatory of the JAX
package's ``telemetry/`` are not ported yet."""
