"""Framework-free helpers of the port: point-cloud file I/O, the YAML
config reader and argument parser of the CLIs, and the parameter EMA."""
