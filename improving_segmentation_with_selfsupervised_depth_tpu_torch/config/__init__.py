"""Configuration of the port: machine paths, YAML loading, the experiment
grid and generator."""

from .loader import expand_cfg_vars, load_config, merge_monodepth_options
from .machine import machine_paths

__all__ = ["expand_cfg_vars", "load_config", "machine_paths", "merge_monodepth_options"]
