"""Training engine of the port: interop, optimizer, train step, trainer."""
