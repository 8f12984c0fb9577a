"""The harness's own machinery: the run, spans, device-time readings, the wire."""
