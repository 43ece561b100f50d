"""The harness: manifest, traffic, weights, the timed window, the trace and
the comparison that decides `correct`."""
