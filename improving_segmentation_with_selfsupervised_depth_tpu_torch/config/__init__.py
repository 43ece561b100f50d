"""Configuration helpers of the port: machine paths."""
