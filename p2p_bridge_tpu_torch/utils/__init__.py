"""Framework-free helpers of the port: point-cloud file I/O and the YAML
config reader of the CLI."""
