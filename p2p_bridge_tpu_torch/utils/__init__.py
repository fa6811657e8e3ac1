"""Helpers of the port: point-cloud file I/O, the YAML config reader and
argument parser of the CLIs, the parameter EMA, the experiment tracker
and Summary CSV, and point-cloud figures."""
